"""Training losses (counterpart of ``repro.train.losses``).

 * fused_ce : streaming softmax CE through the fused CE kernels
   (``kernels.ops.fused_cross_entropy``). The device chooses the
   implementation: CUDA tensors always launch the kernel pair, CPU tensors
   run its plain version. ``backend`` keeps the JAX package's name and
   values ("xla", "pallas") and selects nothing.
 * ce       : naive full-logits CE (small vocab / tests).
 * selfnorm : streaming CE + alpha * log(Z)^2 penalty (Devlin et al.).

``nce``, ``sampled`` and the estimator-backed losses (``mimps_ce``,
``mince_ce``, ``lsh_ce``) are not ported yet and raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..kernels.ops import fused_cross_entropy

BACKENDS = ("xla", "pallas")


def streaming_ce(h, w, labels, *, backend: str = "xla"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll, lse) per token; h (T, d), w (V, d). ``backend`` is accepted
    for the JAX signature; the tensors' device picks kernel or plain
    version."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    return fused_cross_entropy(h, w, labels)


def _flatten_head(model, params, hidden, labels):
    """Returns (h2d (T, d), w (V, d), lab (T,)) for a single-stream head."""
    if model.cfg.n_codebooks:
        raise NotImplementedError(
            "codebook heads are not ported (ROADMAP A15)")
    return (hidden.reshape(-1, hidden.shape[-1]), model.head_matrix(params),
            labels.reshape(-1))


def _moe_terms(aux) -> Dict:
    return {k: v for k, v in aux.items() if "moe" in k}


def loss_fused_ce(model, params, batch, key, train_cfg, *,
                  backend="xla") -> Tuple[torch.Tensor, Dict]:
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = model.forward(params, tokens, img=batch.get("img"))
    h2, w, lab = _flatten_head(model, params, hidden, labels)
    nll, lse = streaming_ce(h2, w, lab, backend=backend)
    loss = nll.mean()
    metrics = {"loss": loss, "ppl_proxy": loss, "mean_log_z": lse.mean(),
               **_moe_terms(aux)}
    total = loss + aux.get("moe_balance", 0.0) + aux.get("moe_zloss", 0.0)
    return total, metrics


def loss_ce(model, params, batch, key, train_cfg) -> Tuple[torch.Tensor,
                                                           Dict]:
    """Naive full-logits CE — small vocabs/tests."""
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = model.forward(params, tokens, img=batch.get("img"))
    logits = model.logits(params, hidden)
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = (lse - picked).mean()
    total = nll + aux.get("moe_balance", 0.0) + aux.get("moe_zloss", 0.0)
    return total, {"loss": nll, "mean_log_z": lse.mean()}


def loss_selfnorm(model, params, batch, key, train_cfg, *,
                  backend="xla") -> Tuple[torch.Tensor, Dict]:
    """CE + alpha log(Z)^2 (Devlin) — trains Z(q) ~= 1 so that serving can
    use method='selfnorm'."""
    tokens, labels = batch["tokens"], batch["labels"]
    hidden, aux = model.forward(params, tokens, img=batch.get("img"))
    h2, w, lab = _flatten_head(model, params, hidden, labels)
    nll, lse = streaming_ce(h2, w, lab, backend=backend)
    alpha = train_cfg.selfnorm_alpha
    penalty = torch.mean(lse ** 2)
    loss = nll.mean() + alpha * penalty
    return loss + aux.get("moe_balance", 0.0), {
        "loss": nll.mean(), "mean_log_z": lse.mean(),
        "selfnorm_penalty": penalty}


def _not_ported(name: str, item: str) -> Callable:
    def loss(*args, **kwargs):
        raise NotImplementedError(
            f"loss {name!r} is not ported to repro_torch yet (ROADMAP {item})")
    loss.__name__ = f"loss_{name}"
    return loss


LOSSES: Dict[str, Callable] = {
    "fused_ce": loss_fused_ce,
    "ce": loss_ce,
    "selfnorm": loss_selfnorm,
    "nce": _not_ported("nce", "A12"),
    "sampled": _not_ported("sampled", "A12"),
    "mimps_ce": _not_ported("mimps_ce", "A12"),
    "mince_ce": _not_ported("mince_ce", "A12"),
    "lsh_ce": _not_ported("lsh_ce", "A11, A12"),
}

# losses whose forward/backward go through a device-resident retrieval index
ESTIMATOR_LOSSES = ("mimps_ce", "mince_ce", "lsh_ce")


def get_loss(name: str) -> Callable:
    return LOSSES[name]
