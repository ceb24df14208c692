"""Process meshes and entry points (counterpart of ``repro.launch``): the
serving and training meshes and their sharding rules (``launch.mesh``)
and the training entry point (``launch.train``)."""
