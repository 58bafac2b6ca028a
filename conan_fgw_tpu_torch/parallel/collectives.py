"""The gradient all-reduce and the host-side gathers of data-parallel
training (the port's counterpart of ``conan_fgw_tpu/parallel/collectives.py``).

The JAX package's gradient ``psum`` is inserted by XLA into the jitted
step; here it is ``all_reduce_``, one SUM over one flat f32 buffer per
step, which ``train/loop.py::SplitStep`` fills and reads. Evaluation
gathers each rank's predictions to every rank in rank order
(``gather_to_host``; the reference's DDP ``all_gather``,
``conan_fgw/src/model/common.py:307-333``), so that every rank computes the
same metrics. Every call takes the caller's ``Mesh`` (``parallel/mesh.py``);
a collective that fails raises.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
import torch.distributed as dist

from conan_fgw_tpu_torch.parallel.mesh import Mesh


def all_reduce_(flat: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``flat`` over the ranks in place. With NCCL the all-reduce is
    enqueued after the current stream's work and the stream waits for it;
    with gloo a CUDA buffer goes through the host (a blocking copy each
    way), a CPU one is reduced where it lies."""
    if flat.device.type == "cuda" and mesh.backend == "gloo":
        host = flat.cpu()
        dist.all_reduce(host, group=mesh.group)
        flat.copy_(host)
    else:
        dist.all_reduce(flat, group=mesh.group)
    return flat


def host_concat(x: np.ndarray, mesh: Mesh | None) -> np.ndarray:
    """Every rank's rows of ``x`` (the same shape on each rank), concatenated
    along the first axis in rank order; ``x`` itself without a mesh."""
    x = np.ascontiguousarray(x)
    if mesh is None or mesh.world == 1:
        return x
    src = torch.from_numpy(x)
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(parts, src, group=mesh.host_group)
    return np.concatenate([p.numpy() for p in parts])


def gather_to_host(x: torch.Tensor, mesh: Mesh | None) -> np.ndarray:
    """``host_concat`` of a tensor on any device: the ranks' rows in rank
    order, as one numpy array."""
    return host_concat(x.detach().cpu().numpy(), mesh)


def all_hosts_mean(value: float, mesh: Mesh | None) -> float:
    """Mean of a Python scalar over the ranks."""
    return float(np.mean(host_concat(np.asarray([value], np.float64), mesh)))


def broadcast_object(obj, mesh: Mesh | None, src: int = 0):
    """Rank ``src``'s ``obj`` on every rank (pickled over the host group)."""
    if mesh is None or mesh.world == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.host_group)
    return box[0]


def check_replicas(model: torch.nn.Module, mesh: Mesh | None) -> None:
    """Raise unless every rank's ``model`` holds the same bits (a digest of
    its ``state_dict`` compared over the host group)."""
    if mesh is None or mesh.world == 1:
        return
    h = hashlib.sha256()
    for name, t in model.state_dict().items():
        h.update(name.encode())
        h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes())
    digests = [None] * mesh.world
    dist.all_gather_object(digests, h.hexdigest(), group=mesh.host_group)
    if len(set(digests)) != 1:
        raise RuntimeError(f"rank {mesh.rank}: the replicas' weights differ: {digests}")
