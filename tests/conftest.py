"""Shared fixtures. NOTE: no XLA_FLAGS device-count override here — smoke
tests and benches must see the single real CPU device; only launch/dryrun.py
sets --xla_force_host_platform_device_count (in its own process)."""
import jax
import jax.numpy as jnp
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def make_clustered_vectors(key, n, d, n_centers=32, spread=0.5,
                           zipf_norms=True):
    """Synthetic word2vec-like class vectors: clustered + rank-scaled norms."""
    k1, k2, k3 = jax.random.split(key, 3)
    centers = jax.random.normal(k1, (n_centers, d))
    asg = jax.random.randint(k2, (n,), 0, n_centers)
    v = centers[asg] + spread * jax.random.normal(k3, (n, d))
    if zipf_norms:
        scale = 1.0 + 2.0 / jnp.sqrt(1.0 + jnp.arange(n))
        v = v * scale[:, None]
    # keep score scale moderate so exp() stays in float32 range
    v = v / jnp.linalg.norm(v, axis=1, keepdims=True) * jnp.sqrt(d) * 0.35
    return v


@pytest.fixture(scope="session")
def vectors(rng):
    return make_clustered_vectors(rng, 8192, 64)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
