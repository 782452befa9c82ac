"""Concurrent launches of the band-ranks isolation check
(tests/test_torch_isolation.py::test_band_ranks_load_no_jax's launcher:
2 gloo CPU ranks via comm.launch, each listing its modules), many at
once, to measure how often the group fails to form under the contention
of a parallel test run.

    PYTHONPATH=. python tests/torch_band_stress.py [runs] [at once]

prints each run's exit code and seconds, then the failed runs with the
start of their stderr. Not collected by pytest (a helper)."""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CODE = (
    "import sys\n"
    f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
    "import json, torch_band_ranks\n"
    "from plainrenderer_tpu_torch.parallel import comm\n"
    "if __name__ == '__main__':\n"
    "    out = comm.launch(torch_band_ranks.loaded_modules, 2,\n"
    "                      device='cpu', timeout=120.0)\n"
    "    print(json.dumps(out))\n")


def one(i: int):
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT,
                         capture_output=True, text=True, timeout=180)
    ok = out.returncode == 0 and len(json.loads(
        out.stdout.strip().splitlines()[-1])) == 2
    return i, out.returncode, ok, time.perf_counter() - t0, out.stderr


def main(runs: int, at_once: int) -> int:
    failed = []
    with ThreadPoolExecutor(at_once) as pool:
        for i, rc, ok, secs, err in pool.map(one, range(runs)):
            print(f"run {i}: rc {rc} {'ok' if ok else 'FAILED'} "
                  f"{secs:.1f} s", flush=True)
            if not ok:
                failed.append((i, err))
    for i, err in failed:
        print(f"--- run {i} stderr ---\n{err[-2000:]}")
    print(f"{len(failed)} of {runs} runs failed, {at_once} at once")
    return len(failed)


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]]
    sys.exit(1 if main(*(args + [96, 20][len(args):])) else 0)
