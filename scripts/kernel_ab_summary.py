"""Summarize a kernels-only A/B of chip_smoke.py.

Run on one card, in one call, in the order parent, change, change, parent:

    python3 chip_smoke.py --kernels-only --skip-flex --package-root PARENT > p1.jsonl
    python3 chip_smoke.py --kernels-only --skip-flex > c1.jsonl
    python3 chip_smoke.py --kernels-only --skip-flex > c2.jsonl
    python3 chip_smoke.py --kernels-only --skip-flex --package-root PARENT > p2.jsonl
    python3 scripts/kernel_ab_summary.py p1.jsonl c1.jsonl c2.jsonl p2.jsonl

prints, per timed case, the mean of each side's two runs of ms and
device_ms, the change's spread between its two runs, and bound_ms.
"""

from __future__ import annotations

import json
import sys


def timed(path: str) -> dict:
    """(kernel, timed_case) -> the timing line of one run."""
    rows = {}
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if rec.get("phase") == "kernels" and "timed_case" in rec:
                rows[(rec["kernel"], rec["timed_case"])] = rec
    return rows


def main(argv) -> int:
    p1, c1, c2, p2 = (timed(p) for p in argv[1:5])
    print(f"{'kernel':30s} {'case':22s} {'ms parent -> change':>22s} "
          f"{'device ms parent -> change':>28s} {'spread':>7s} {'bound':>7s}")
    for key in sorted(set(c1) & set(p1)):
        par = [r[key] for r in (p1, p2) if key in r]
        chg = [r[key] for r in (c1, c2) if key in r]
        mean = lambda rs, k: sum(r[k] for r in rs) / len(rs)  # noqa: E731
        spread = max(r["device_ms"] for r in chg) - min(r["device_ms"] for r in chg)
        print(f"{key[0]:30s} {key[1]:22s} {mean(par, 'ms'):9.4f} -> {mean(chg, 'ms'):7.4f} "
              f"{mean(par, 'device_ms'):14.4f} -> {mean(chg, 'device_ms'):7.4f} "
              f"{spread:7.4f} {chg[0]['bound_ms']:7.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
