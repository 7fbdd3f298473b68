"""Test-seconds by test file from pytest junit XML files, side by side.

    python tools/junit_seconds.py parent.xml change.xml [--match test_torch_]

Sums each test case's ``time`` by the file it came from (the ``classname``
up to its last module part) and prints one row a file with its seconds in
each XML file, then the totals. Under ``pytest -n N --dist loadfile`` one
worker runs a file whole, so a file's sum is the time it held its worker;
the run's wall is set by the busiest worker, not by the total.
"""

from __future__ import annotations

import argparse
import xml.etree.ElementTree as ET
from collections import defaultdict


def seconds_by_file(path: str) -> dict:
    out = defaultdict(float)
    for case in ET.parse(path).getroot().iter("testcase"):
        parts = case.get("classname", "").split(".")
        # "tests.test_x" or "tests.test_x.TestClass" -> "test_x"
        mod = next((p for p in parts if p.startswith("test_")), parts[-1])
        out[mod] += float(case.get("time", 0.0))
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml", nargs="+", help="junit XML files, in column order")
    ap.add_argument("--match", default="",
                    help="only files whose name holds this string")
    args = ap.parse_args(argv)
    runs = [seconds_by_file(p) for p in args.xml]
    files = sorted({f for r in runs for f in r if args.match in f},
                   key=lambda f: -max(r.get(f, 0.0) for r in runs))
    for f in files:
        print(f"{f:40s} " + " ".join(
            f"{r[f]:9.1f}" if f in r else f"{'-':>9s}" for r in runs))
    print(f"{'all':40s} " + " ".join(
        f"{sum(r.get(f, 0.0) for f in files):9.1f}" for r in runs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
