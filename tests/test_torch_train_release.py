"""``train.run`` returns with its training state freed.

The first ``torch.utils.checkpoint`` of a process imports ``torch._dynamo``;
imported inside a train step, it left that step's frames, and the
parameters and moments their locals held, in a reference cycle until the
next collection (``torch.fx``'s ``wrap`` keeps its own frame).  The
transformer now imports it on a thread of its own
(``transformer._import_checkpoint_deps``).  The check runs in a fresh
interpreter, where nothing has imported ``torch._dynamo`` yet, with the
collector off, so that a cycle would hold the state for certain: a weak
reference to a parameter and to a first moment, taken in the first step,
and to each step's gradient of the embedding must be dead when ``run``
returns, with no ``gc.collect()``.  (The gradients were held by a second
cycle: ``core/tree.unflatten``'s recursive closure, which kept the list of
leaves it filled from.)
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import gc, sys, weakref
gc.disable()
from repro_torch.launch import steps, train
assert "torch._dynamo" not in sys.modules
refs = []
real = steps.jit_train_step

def jit_train_step(*args, **kwargs):
    step, *rest = real(*args, **kwargs)

    def first_held(state, batch):
        if not refs:
            refs.extend(weakref.ref(t) for t in (
                state["params"]["embed"], state["opt"]["m"]["embed"]))
        return step(state, batch)
    return (first_held, *rest)

real_grads = steps.train_grads


def train_grads(*args, **kwargs):
    loss, grads = real_grads(*args, **kwargs)
    refs.append(weakref.ref(grads["embed"]))
    return loss, grads


steps.jit_train_step = jit_train_step
steps.train_grads = train_grads
train.run(steps=2, batch=2, seq=32, log_every=100, device="cpu")
print("ALIVE", [r() is not None for r in refs])
"""


def test_train_run_frees_its_state_without_a_collection():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ALIVE [False, False, False, False]" in res.stdout, res.stdout
