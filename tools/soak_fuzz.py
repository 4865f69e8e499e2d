# -*- coding: utf-8 -*-
"""Extended-seed soak of the randomized property tests.

The committed suite runs a handful of seeds per fuzz test (CI budget);
this tool re-runs them across a wide seed range for pre-release
confidence sweeps (a skip is a random configuration no window plan
fits).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python tools/soak_fuzz.py [start] [stop]
"""
import os
import sys
import traceback

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))
from _pytest.outcomes import Skipped  # noqa: E402

import test_sor2d as mk               # noqa: E402
import test_sharded_fuzz as ms        # noqa: E402
import test_lexico as ml              # noqa: E402


def main():
    start = int(sys.argv[1]) if len(sys.argv) > 1 else 100
    stop = int(sys.argv[2]) if len(sys.argv) > 2 else 130
    counts = {"ok": 0, "skip": 0, "fail": 0}

    def run(fn, seed):
        try:
            fn(seed)
            counts["ok"] += 1
        except Skipped:
            counts["skip"] += 1
        except BaseException:
            counts["fail"] += 1
            print(f"FAIL {fn.__name__}({seed})")
            traceback.print_exc()

    for seed in range(start, stop):
        run(mk.test_fuzz_executor, seed)
        run(ms.test_fuzz_sharded_2d, seed)
        run(ms.test_fuzz_sharded_3d, seed)
        run(ms.test_fuzz_checked_sharded_3d, seed)
        run(ms.test_fuzz_checked_sharded_2d, seed)
        run(ml.test_checked_lexico_stopping_matches_python_loop, seed)
        print(f"seed {seed} done {counts}", flush=True)
    print("SOAK COMPLETE:", counts)
    return 1 if counts["fail"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
