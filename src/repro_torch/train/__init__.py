"""Training: streaming-CE losses, AdamW, and the train-step factory."""
from .losses import ESTIMATOR_LOSSES, LOSSES, get_loss, streaming_ce
from .optimizer import adamw_update, init_opt_state, lr_schedule
from .train_loop import (TrainMetricState, TrainState, harvest_train_metrics,
                         init_train_metric_state, init_train_state,
                         make_train_step, observe_train_step)

__all__ = ["ESTIMATOR_LOSSES", "LOSSES", "get_loss", "streaming_ce",
           "adamw_update", "init_opt_state", "lr_schedule",
           "TrainMetricState", "TrainState", "harvest_train_metrics",
           "init_train_metric_state", "init_train_state", "make_train_step",
           "observe_train_step"]
