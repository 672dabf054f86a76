"""Plain version of the fused FlexHyCA protected matmul kernel.

Counterpart of ``repro.kernels.protected_mm.ref``: ``inject_ref`` of two
independent plane streams composed with ``qmatmul_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.fault_inject.ref import inject_ref
from repro_torch.kernels.qmatmul.ref import qmatmul_ref


def protected_mm_ref(xq, wq, rnd_ord, rnd_imp, imp_mask, *, t: int, ber,
                     ib: int, nb: int, bits: int = 8):
    """FlexHyCA PE-array semantics:

      - every output computed on the 2-D array: faults at ``ber`` with the
        top ``nb`` bits TMR-protected,
      - important output channels recomputed on the DPPU: an independent
        fault draw with the top ``ib`` bits protected; the DPPU result
        overrides.
    Returns (M, N) int8.
    """
    yq = qmatmul_ref(xq, wq, t).to(torch.int32)
    n = wq.shape[1]
    prot_ord = torch.full((n,), nb, dtype=torch.int32, device=yq.device)
    prot_imp = torch.full((n,), ib, dtype=torch.int32, device=yq.device)
    y_ord = inject_ref(yq, rnd_ord, prot_ord, ber, bits)
    y_imp = inject_ref(yq, rnd_imp, prot_imp, ber, bits)
    return torch.where(imp_mask.reshape(1, -1) != 0, y_imp, y_ord).to(
        torch.int8)
