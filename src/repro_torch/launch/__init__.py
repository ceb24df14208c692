"""Process-mesh set-up for serving (counterpart of ``repro.launch``; the
port carries the serving mesh of ``launch.mesh``)."""
