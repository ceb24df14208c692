"""Process meshes and entry points (counterpart of ``repro.launch``): the
serving and training meshes and their sharding rules (``launch.mesh``),
the training entry point (``launch.train``), the serving entry point
(``launch.serve``), the trace summary (``launch.obs_report``) and the
dry run (``launch.dryrun``, counting with ``launch.hlo_analysis`` and
ranked by ``launch.breakdown``). Each entry point is a module with
``main(argv=None)``, run as ``python -m repro_torch.launch.<name>``."""

__all__ = ["mesh", "train", "serve", "obs_report", "dryrun", "hlo_analysis",
           "breakdown"]
