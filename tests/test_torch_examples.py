"""The port's examples (examples/torch_*.py) run to exit 0 on the CPU with
``--device cpu`` at their smallest arguments, and without ``--device``
they refuse the CPU (there is no card here): they raise, as
``repro_torch.device.resolve`` does, before any work.

One subprocess at one thread, under a timeout, runs the four examples in
turn (each first with no arguments, which must raise, then with its
arguments).
The DSE example runs its DSE (``--iters 1``: the 12 initial candidates)
on a smaller oracle than its defaults (20 training steps, 16 images, 1
fault draw, patched into ``repro_torch.core.evaluate.trained_cnn``): at
the defaults one accuracy under faults takes ~35 s of CPU draws.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
EX = REPO / "examples"
TIMEOUT = 240
DSE_ORACLE = dict(steps=20, n_eval=16, n_rep=1)
# the subprocess runs the examples in turn: each one's main() with no
# arguments must refuse the CPU (no card here), then it runs with its
# arguments; the last line is {example: {"rc", "stdout", "stderr"}}
RUN = f"""
import contextlib, dataclasses, io, json, runpy, sys, traceback
from repro_torch.core import evaluate as E

def trained_cnn(arch="vgg", steps=250, device=None):
    o = E._trained(arch, {DSE_ORACLE['steps']}, 0.0, None, None,
                   E._device.resolve(device))
    return dataclasses.replace(o, n_eval={DSE_ORACLE['n_eval']},
                               n_rep={DSE_ORACLE['n_rep']})
E.trained_cnn = trained_cnn
out = {{}}
for path, args in json.loads(sys.argv[1]):
    buf, rc, err = io.StringIO(), 0, ""
    try:
        with contextlib.redirect_stdout(buf):
            main = runpy.run_path(path)["main"]
            try:
                main([])
            except RuntimeError as e:
                assert "no CUDA device" in str(e), e
                print("refused the CPU unasked")
            else:
                raise AssertionError("ran on the CPU unasked")
            main(args)
    except BaseException:
        rc, err = 1, traceback.format_exc()
    out[path.rsplit("/", 1)[-1]] = dict(rc=rc, stdout=buf.getvalue(),
                                        stderr=err)
print(json.dumps(out))
"""
def _commands(tmp):
    cpu = ["--device", "cpu"]
    return {
        "torch_quickstart.py": cpu,
        "torch_fault_tolerant_serving.py": cpu,
        "torch_train_lm.py": ["--steps", "2", "--layers", "2", "--d-model",
                              "64", "--seq", "32", "--batch", "2",
                              "--ckpt-dir", os.path.join(tmp, "lm")] + cpu,
        "torch_crosslayer_dse.py": ["--iters", "1"] + cpu,
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{example: (rc, stdout, stderr)}."""
    tmp = str(tmp_path_factory.mktemp("examples"))
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-c", RUN, json.dumps(
            [(str(EX / n), args) for n, args in _commands(tmp).items()])],
        env=env, cwd=tmp, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return lambda name: (out[name]["rc"], out[name]["stdout"],
                         out[name]["stderr"])


@pytest.mark.parametrize("name, want", [
    ("torch_quickstart.py", "\narea overhead:"),
    ("torch_fault_tolerant_serving.py", "\nscheduler roundtrips: 16 "),
    ("torch_train_lm.py", "\ndone at step 2:"),
    ("torch_crosslayer_dse.py", "\nconstraints: acc >= "),
], ids=["quickstart", "fault_tolerant_serving", "train_lm", "crosslayer_dse"])
def test_example_runs_on_cpu(name, want, runs):
    rc, stdout, stderr = runs(name)
    assert rc == 0, stderr[-4000:]
    assert want in stdout, stdout[-2000:]


def test_examples_refuse_the_cpu_unasked(runs):
    assert sorted(p.name for p in EX.glob("torch_*.py")) == sorted(
        _commands(""))
    for name in _commands(""):
        rc, stdout, stderr = runs(name)
        assert rc == 0, stderr[-4000:]
        assert stdout.startswith("refused the CPU unasked\n"), stdout[:200]
