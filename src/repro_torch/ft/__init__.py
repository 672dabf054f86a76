"""``repro_torch.ft`` — the public fault-tolerance API.

Counterpart of ``repro.ft``:

    from repro_torch import ft

    policy = ft.get_policy("cl", ber=1e-3)
    y = ft.protect_linear(key, x, w, policy, important=m)            # reference
    y = ft.protect_linear(key, x, w, policy, important=m, backend="fused")
    t = ft.calibrate_t(x, w)                     # deployment state
    y = ft.protect_linear(key, x, w, policy, important=m, backend="pallas",
                          t=t)
    y = ft.protect_linear_ste(key, x, w, policy)   # FAT: clean gradients
"""
from repro_torch.ft.policy import (AlgorithmLayer, ArchLayer,  # noqa: F401
                                   CircuitLayer, ProtectionPolicy)
from repro_torch.ft.registry import (get_policy, list_policies,  # noqa: F401
                                     paper_policies, register_policy)
# compat and api import after policy/registry are bound
# isort: split
from repro_torch.ft.compat import as_policy, from_ftconfig  # noqa: F401
# isort: split
from repro_torch.ft.api import (BACKENDS, calibrate_t,  # noqa: F401
                                protect_linear, protect_linear_ste)
