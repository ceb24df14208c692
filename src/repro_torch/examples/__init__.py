"""Runnable examples (counterparts of the repository's ``examples/``), each
a ``main(argv=None)`` with the JAX scripts' sizes as defaults, ``--device``
(``cuda`` by default) and size flags, run as
``python -m repro_torch.examples.<name>``:

- ``quickstart``: every estimator of the paper on word2vec-like vectors;
- ``serve_sublinear``: batched decode under each serving method;
- ``serve_traffic``: continuous batching, then the prefix pool and
  speculation, each request's tokens equal to its solo ``generate``;
- ``train_sublinear``: ``mimps_ce`` training, a checkpoint round trip and
  ``swap_index`` into a live scheduler;
- ``train_selfnorm_vs_mimps``: the self-normalisation penalty, then MIMPS
  against the Z = 1 shortcut on held-out contexts.
"""

__all__ = ["quickstart", "serve_sublinear", "serve_traffic",
           "train_sublinear", "train_selfnorm_vs_mimps"]
