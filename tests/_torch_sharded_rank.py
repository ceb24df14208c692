"""One rank of ``tests/test_torch_sharded_decode.py`` (and, with ``cuda``,
of ``tests/test_torch_cuda_sharded_decode.py``): a gloo group of ``world``
ranks from a ``FileStore``, mesh (1, world), running the dry-run bodies of
``serve.output_layer`` on this rank's blocks of the index in
``<out>/inputs.npz`` (written by the pytest process, which computes JAX's
references; no JAX here). Writes ``<out>/rank<r>.pt``: for each case and
each of ``use_kernel`` True and False, (log_z, top_id, top_score).

    python tests/_torch_sharded_rank.py RANK WORLD STORE OUT [cuda]
"""
import datetime
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch.distributed as dist  # noqa: E402

from repro_torch.core.feature_maps import FeatureMap, FMBEState  # noqa: E402
from repro_torch.launch.mesh import make_serving_mesh  # noqa: E402
from repro_torch.serve.output_layer import IVFSpecs, sharded_decode  # noqa

# (name, method, n_probe_local, l_local): the cases of the test
CASES = (("mimps", "mimps", 2, 16), ("mince", "mince", 2, 16),
         ("fmbe", "fmbe", 4, 0), ("mimps_all", "mimps", 8, 16),
         ("mince_all", "mince", 8, 16))


def main(rank: int, world: int, store: str, out: str, dev: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_serving_mesh(1, world, device_type=dev)
        z = np.load(os.path.join(out, "inputs.npz"))

        def t(name):
            return torch.from_numpy(np.ascontiguousarray(z[name])).to(dev)
        nb = z["v_blocks"].shape[0]
        part = slice(rank * nb // world, (rank + 1) * nb // world)
        dtype = getattr(torch, os.environ.get("SHARDED_DTYPE", "float32"))
        ivf = IVFSpecs(v_blocks=t("v_blocks")[part].to(dtype).contiguous(),
                       centroids=t("centroids")[part].to(dtype).contiguous(),
                       radius=t("radius")[part].contiguous(),
                       valid=t("valid")[part].contiguous())
        h = t("h").to(dtype)
        fm = FeatureMap(omega=t("omega").float(),
                        degree=t("degree").to(torch.int32),
                        coef=t("coef").float(), p=float(z["p"]))
        fstate = FMBEState(fm=fm, lambda_tilde=t("lambda_tilde").float())
        if dev == "cuda":
            from repro_torch.kernels.fmbe import fmbe_pack
            fstate = fstate._replace(pack=fmbe_pack(fm.omega, fm.degree,
                                                    fm.coef))
        res = {}
        for name, method, p, l in CASES:
            kw = {"fmbe_state": fstate} if method == "fmbe" else {
                "slots": t(f"slots_{l}")[rank]}
            if method == "mince":
                kw.update(iters=3, solver="halley")
            for use_kernel in (True, False):
                got = sharded_decode(mesh, method, ivf, h, n_probe_local=p,
                                     l_local=l, use_kernel=use_kernel, **kw)
                res[(name, use_kernel)] = tuple(x.cpu() for x in got)
        if dev == "cuda":
            from repro_torch.kernels.fmbe import fmbe_z
            from repro_torch.kernels.ivf_score import ivf_score
            res["launches"] = {"ivf_score": ivf_score.launches,
                               "fmbe_z": fmbe_z.launches}
        torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5] if len(sys.argv) > 5 else "cpu")
