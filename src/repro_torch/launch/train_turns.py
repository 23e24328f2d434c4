"""Time ``train.run``'s steps of two source trees in turns, on one device.

    python -m repro_torch.launch.train_turns BEFORE/src AFTER/src \
        [--rounds 2] [--steps 20] [--out FILE]

Each run is a subprocess with ``PYTHONPATH`` set to one tree's ``src``:
llama2-110m at full width and depth, batches of 8 x 256, ``--steps``
steps from seed 0, as phase 27 of ``chip_smoke.py`` trains it.  The runs
go before, after, after, before (``--rounds`` such pairs, mirrored), so a
drift of the machine falls on both trees alike.  Each run reports the
median over its steps after the first of ``device_ms`` (the step itself,
synchronized) and ``data_ms`` (the batch drawn on the host), and its
first and last loss; the two trees must log the same losses.  Prints
one JSON object, the runs in order, and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_RUN = """
import json, sys
import numpy as np
from repro_torch.launch import train
recs = []
train.run(arch="llama2-110m", use_reduced=False, batch=8, seq=256,
          steps=int(sys.argv[1]), log_every=10 ** 9, on_step=recs.append)
rest = recs[1:] or recs
print(json.dumps({k: float(np.median([r[k] for r in rest]))
                  for k in ("device_ms", "data_ms")}
                 | {"losses": [recs[0]["loss"], recs[-1]["loss"]]}))
"""


def run_tree(src: str, steps: int) -> dict:
    """One subprocess of ``_RUN`` on the tree whose package is in ``src``."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(src))
    out = subprocess.run([sys.executable, "-c", _RUN, str(steps)], env=env,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="")
    a = ap.parse_args(argv)
    order = []
    for i in range(a.rounds):
        pair = [("before", a.before), ("after", a.after)]
        order += pair if i % 2 == 0 else pair[::-1]
    runs = []
    for name, src in order:
        runs.append({"tree": name, **run_tree(src, a.steps)})
        print(json.dumps(runs[-1]), file=sys.stderr, flush=True)
    same = len({json.dumps(r["losses"]) for r in runs}) == 1
    res = {"runs": runs, "same_losses": same}
    print(json.dumps(res))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
