"""Run the paper's full cross-layer design-space exploration (Fig. 1 /
Alg. 3) with the PyTorch port on the reduced VGG benchmark and print the
Table-II-style optimum.

  PYTHONPATH=src python examples/torch_crosslayer_dse.py [--ber 1e-3] \
      [--iters 16] [--batch 8] [--device cpu]

The port's counterpart of examples/crosslayer_dse.py.  --batch q proposes
q candidates per BO round (constant-liar q-EI) and evaluates them through
the batch oracle (``CnnOracle.accuracy_batch``, see docs/dse.md).  Runs on
the GPU unless ``--device cpu`` is given; with no GPU and no such request
it raises.  The CNN trains from the port's own initial weights, so the
accuracies are not the reference example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import device as _device  # noqa: E402
from repro_torch.core import bayesopt as B  # noqa: E402
from repro_torch.core.evaluate import trained_cnn  # noqa: E402
from repro_torch.core.perfmodel import vgg16_gemms  # noqa: E402
from repro_torch.core.pipeline import optimize  # noqa: E402

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ber", type=float, default=1e-3)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--batch", type=int, default=1,
                    help="DSE candidates evaluated per BO round (q-EI)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    print("training the reduced VGG benchmark ...")
    oracle = trained_cnn("vgg", steps=250, device=dev)
    clean = oracle.accuracy(None)
    print(f"clean accuracy: {clean:.3f}")

    cons = B.Constraints(acc_min=0.97 * clean, perf_max=0.10, bw_max=0.10)
    print(f"constraints: acc >= {cons.acc_min:.3f}, perf/bw loss <= 10%")

    res = optimize(lambda pol: oracle.accuracy(pol), vgg16_gemms(), cons,
                   args.ber, iter_max_step=args.iters, seed=0,
                   batch_size=args.batch,
                   acc_oracle_batch=oracle.accuracy_batch)
    if res.policy is None:
        print("no feasible design found: raise --iters")
        return
    pol = res.policy
    print("\noptimized cross-layer design (cf. paper Table II):")
    for layer in (pol.algorithm, pol.arch, pol.circuit):
        for f, v in vars(layer).items():
            print(f"  {f:16s} = {v}")
    print(f"  area overhead = {res.area_overhead*100:.1f}% "
          f"(evaluations: {res.dse.evaluations}, pruned: {res.dse.pruned})")
    print(f"  accuracy under fault: {oracle.accuracy(pol):.3f}")


if __name__ == "__main__":
    main()
