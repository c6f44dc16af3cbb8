"""VTOP: vCPU-topology inference from within the VM (Guo et al., EuroSys'25).

The paper integrates VTOP into VEV (§3.1) because LLC eviction-set
construction needs thread pairs placed in the *same LLC domain* — topology
the hypervisor hides.  VTOP infers vCPU->LLC-domain grouping by measuring
inter-vCPU cache-line transfer latency: a line recently written by vCPU A is
served from the shared LLC when vCPU B is in A's domain (fast) and from DRAM
when it is not (slow).

The paper's §5 notes VTOP is rewritten in C and its propagation "optimized
by skipping checks that cannot aid vCPU distance inference" — mirrored here
by only probing the pairs still unresolved by transitivity.

VTOP cannot recover the vCPU->core mapping (needed for slice filtering [45]),
which is why the paper cannot adopt slice filtering; neither do we.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.core.cachesim import LLC_MISS_THRESHOLD
from repro_torch.core.host_model import GuestVM


def probe_pair_latency(vm: GuestVM, vcpu_a: int, vcpu_b: int,
                       probe_gvas: List[int]) -> float:
    """Median latency for vcpu_b to read lines just touched by vcpu_a.

    One *fresh* line per repetition: a stale line would already sit in
    vcpu_b's private caches and read as a false same-domain hit.
    """
    lats = []
    for g in probe_gvas:
        vm.access([g], vcpu=vcpu_a)
        vm.warm_timer()
        lats.append(int(vm.timed_access([g], vcpu=vcpu_b)[0]))
    return float(np.median(lats))


def infer_llc_domains(vm: GuestVM, probe_pages: np.ndarray,
                      reps: int = 3) -> List[List[int]]:
    """Group vCPUs into LLC domains.  Returns a list of vcpu-id groups.

    Transitivity pruning: once vcpu j is known to share (or not share) a
    domain with a resolved group representative, pairs inside the group are
    skipped — the "skipping checks that cannot aid inference" optimization.
    `probe_pages`: guest pages providing fresh probe lines.
    """
    n = vm.n_vcpus
    groups: List[List[int]] = []
    cursor = 0

    def fresh(k: int) -> List[int]:
        nonlocal cursor
        out = [vm.gva(int(probe_pages[(cursor + i) % len(probe_pages)]),
                      ((cursor + i) * 64) % 4096) for i in range(k)]
        cursor += k
        return out

    for v in range(n):
        placed = False
        for g in groups:
            rep = g[0]
            lat = probe_pair_latency(vm, rep, v, fresh(reps))
            if lat < LLC_MISS_THRESHOLD:  # served from the shared LLC
                g.append(v)
                placed = True
                break
        if not placed:
            groups.append([v])
    return groups


def domain_of(groups: List[List[int]]) -> Dict[int, int]:
    return {v: gi for gi, g in enumerate(groups) for v in g}
