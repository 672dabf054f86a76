"""Quickstart on the PyTorch port: the paper's cross-layer fault-tolerance
stack through the ``repro_torch.ft`` protection-policy API.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The port's counterpart of examples/quickstart.py, step for step:

1. computes a linear layer through the bit-exact DLA datapath,
2. injects soft errors at BER 1e-2 and watches accuracy collapse
   (``ft.get_policy("base")``: the unprotected design),
3. turns on the paper's cross-layer policy (``ft.get_policy("cl")``:
   important neurons, high-bit TMR and the Q_scale constraint) and
   watches it recover,
4. sweeps the BER axis with one policy (``with_ber``),
5. prices the protection with the circuit-level area model.

Runs on the GPU unless ``--device cpu`` is given; with no GPU and no such
request it raises.  The operands are drawn from ``torch.Generator``, so the
errors are not the reference example's numbers.  ``backend="fused"`` runs
the same call through the hand-written CUDA kernel
(``repro_torch.kernels.fused_decode``).
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch import device as _device  # noqa: E402
from repro_torch import ft  # noqa: E402
from repro_torch.core import area, prng  # noqa: E402
from repro_torch.core.flexhyca import clean_linear  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((128, 256), generator=g, device=dev)
    w = torch.randn((256, 64), generator=g, device=dev)
    kfault = prng.PRNGKey(0, dev)
    ref = clean_linear(x, w)

    def rel_rms(y):
        return float(torch.sqrt(torch.mean((y - ref) ** 2))
                     / torch.sqrt(torch.mean(ref ** 2)))

    ber = 1e-2
    print(f"substrate BER = {ber} (compute-array soft errors; weight SRAM "
          "has ECC)")

    # --- unprotected DLA ---------------------------------------------------
    base = ft.get_policy("base", ber=ber, weight_faults=False)
    y_base = ft.protect_linear(kfault, x, w, base)
    print(f"unprotected      rel-RMS error: {rel_rms(y_base):.4f}")

    # --- the paper's cross-layer protection --------------------------------
    # neuron dimension: mark the 10% of output channels with the largest
    # downstream weight as important (a stand-in for Algorithm 1's gradients)
    importance = w.abs().sum(0)
    important = importance >= torch.quantile(importance, 0.9)
    cl = ft.get_policy("cl", ber=ber, s_th=0.1, ib_th=4, nb_th=2,
                       q_scale=7, weight_faults=False)
    # ftlint: disable=FTL001 -- same fault stream as the unprotected design
    y_cl = ft.protect_linear(kfault, x, w, cl, important=important)
    print(f"TMR-CL protected rel-RMS error: {rel_rms(y_cl):.4f}")

    # --- sweep the BER axis with one policy --------------------------------
    errs = []
    for b in (1e-4, 1e-3, 1e-2, 5e-2):
        y = ft.protect_linear(kfault, x, w, cl.with_ber(b),
                              important=important)
        errs.append(f"{b:g}: {rel_rms(y):.4f}")
    errs = ", ".join(errs)
    print(f"BER sweep (TMR-CL) - {errs}")

    # --- what does it cost in silicon? -------------------------------------
    r = area.array_area(32, nb_th=cl.circuit.nb_th,
                        q_scale=cl.algorithm.q_scale,
                        pe_policy=cl.circuit.pe_policy,
                        dot_size=cl.arch.dot_size, ib_th=cl.circuit.ib_th)
    full_tmr = area.full_tmr_pe_cost() / area.pe_cost()
    print(f"area overhead: {r['overhead'] * 100:.1f}% of the 2-D array "
          f"(classic TMR: {100 * (full_tmr - 1):.0f}%)")


if __name__ == "__main__":
    main()
