"""Training: the losses, AdamW, the train-step factory (one device or a
mesh), gradient compression, the elastic mesh and straggler watchdog, the
index refresh and checkpoints."""
from .losses import ESTIMATOR_LOSSES, LOSSES, get_loss, streaming_ce
from .optimizer import adamw_update, init_opt_state, lr_schedule
from .train_loop import (TrainMetricState, TrainState, harvest_train_metrics,
                         init_train_metric_state, init_train_state,
                         make_index_refresh, make_instrumented_step,
                         make_train_step, observe_train_step,
                         params_placements, state_shardings)
from .checkpoint import CheckpointManager
from .compression import compress_psum
from .elastic import StragglerWatchdog, best_mesh_shape, make_elastic_mesh

__all__ = ["ESTIMATOR_LOSSES", "LOSSES", "get_loss", "streaming_ce",
           "adamw_update", "init_opt_state", "lr_schedule",
           "TrainMetricState", "TrainState", "harvest_train_metrics",
           "init_train_metric_state", "init_train_state", "make_index_refresh",
           "make_instrumented_step", "make_train_step", "observe_train_step",
           "params_placements", "state_shardings", "CheckpointManager",
           "compress_psum", "StragglerWatchdog", "best_mesh_shape",
           "make_elastic_mesh"]
