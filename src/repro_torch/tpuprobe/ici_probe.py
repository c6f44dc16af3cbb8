"""Link probing: timed collectives per mesh axis (VTOP for cards).

The port of `repro.tpuprobe.ici_probe`.  The paper's VTOP infers hidden
vCPU topology from cache-line transfer latencies; across cards the hidden
quantity is per-axis / per-link health (a degraded NVLink, a slow
neighbour, traffic of another tenant).  We time (a) a small all-reduce
(the JAX ``psum``, divided by the axis size) on each mesh axis's process
group and (b) a ring of sends and receives on it (the JAX ``ppermute``):
which axis and hop is slow shows in those times.

The collectives always run (they prove the groups work); the times come
from the host clock around each, synchronized.  With an injected
``link_model(axis, hop) -> slowdown`` they are synthesized from
`launch.mesh.ICI_BW_PER_LINK` exactly as the JAX module does, so the
inference (ranking axes, flagging degraded hops) runs the same anywhere.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh import ICI_BW_PER_LINK

__all__ = ["probe_axes", "rank_axes_by_health", "degraded_hops"]


def _device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _axis_psum_probe(mesh: DeviceMesh, axis: str, n_floats: int = 1 << 16):
    """(fn, x): ``fn(x)`` is this rank's shard of the all-reduce of ``x``
    over ``axis``'s group, divided by the axis size; ``x`` is this rank's
    ``n_floats`` ones."""
    group, size = mesh.get_group(axis), mesh.size(_dim(mesh, axis))

    def probe(x):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / size

    return probe, torch.ones((n_floats,), dtype=torch.float32,
                             device=_device(mesh))


def _ring_permute_probe(mesh: DeviceMesh, axis: str,
                        n_floats: int = 1 << 16):
    """(fn, x): ``fn(x)`` sends ``x`` to the next rank of ``axis``'s ring
    and returns what the previous one sent; on an axis of size 1 it is
    ``x`` itself (no send to self)."""
    group, size = mesh.get_group(axis), mesh.size(_dim(mesh, axis))

    def probe(x):
        if size == 1:
            return x.clone()
        me = dist.get_rank(group)
        dst = dist.get_global_rank(group, (me + 1) % size)
        src = dist.get_global_rank(group, (me - 1) % size)
        y = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x, dst, group=group),
            dist.P2POp(dist.irecv, y, src, group=group)])
        for r in reqs:
            r.wait()
        return y

    return probe, torch.ones((n_floats,), dtype=torch.float32,
                             device=_device(mesh))


def _dim(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def probe_axes(mesh: DeviceMesh,
               link_model: Optional[Callable[[str, int], float]] = None,
               n_floats: int = 1 << 14) -> Dict[str, Dict]:
    """Returns per-axis {psum_s, ring_s, slowdown, size} estimates; every
    rank of the mesh must call it.

    With `link_model` the timing is synthesized on top of the functional
    collectives, which still run (proving the groups work).  ``nbytes`` is
    the whole axis's buffer, ``size`` x ``n_floats`` f32, as in JAX.
    """
    out: Dict[str, Dict] = {}
    for axis in mesh.mesh_dim_names:
        size = mesh.size(_dim(mesh, axis))
        psum_fn, px = _axis_psum_probe(mesh, axis, n_floats)
        ring_fn, rx = _ring_permute_probe(mesh, axis, n_floats)
        # functional execution (validity proof; negligible data)
        _sync(psum_fn(px))
        _sync(ring_fn(rx))
        nbytes = size * n_floats * 4
        nominal = nbytes / ICI_BW_PER_LINK
        if link_model is None:
            t0 = time.perf_counter()
            _sync(psum_fn(px))
            t_psum = time.perf_counter() - t0
            t0 = time.perf_counter()
            _sync(ring_fn(rx))
            t_ring = time.perf_counter() - t0
        else:
            worst = max(link_model(axis, h) for h in range(size))
            t_psum = nominal * 2 * worst     # ring all-reduce ~ 2 passes
            t_ring = nominal * worst
        out[axis] = {
            "psum_s": t_psum,
            "ring_s": t_ring,
            "slowdown": max(1.0, t_ring / max(nominal, 1e-12)),
            "size": size,
        }
    return out


def rank_axes_by_health(axis_stats: Dict[str, Dict]) -> list:
    """Least-contended axis first (consumed by the rebalancer when choosing
    where to place bandwidth-hungry collectives, e.g. grad compression only
    on the slowest axis)."""
    return sorted(axis_stats, key=lambda a: axis_stats[a]["slowdown"])


def degraded_hops(mesh: DeviceMesh, axis: str,
                  link_model: Callable[[str, int], float],
                  threshold: float = 1.3) -> list:
    """Per-hop ring probes isolate WHICH link is sick (VTOP's pairwise
    latency matrix, one axis at a time)."""
    return [h for h in range(mesh.size(_dim(mesh, axis)))
            if link_model(axis, h) > threshold]
