"""Canonical flow of the C library's simple_example on the port:

create handle -> load pattern file -> dump transition table ->
match from host -> print per-position pattern IDs.

Run:  python -m pfac_tpu_torch.examples.simple_example [--device cpu]
(the card by default; the repository's example pattern and input unless
-P / -I name others).
"""
import argparse
import os

import numpy as np

from pfac_tpu_torch.runtime import capi
from pfac_tpu_torch.status import PfacStatus

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..")
PATTERN_FILE = os.path.join(ROOT, "tests", "pattern", "example_pattern")
INPUT_FILE = os.path.join(ROOT, "tests", "data", "example_input")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-P", "--patterns", default=PATTERN_FILE)
    ap.add_argument("-I", "--input", default=INPUT_FILE)
    ap.add_argument("--table", default="table.txt",
                    help="where the transition table is dumped")
    args = ap.parse_args(argv)

    handle = [None]
    assert capi.PFAC_create(handle, device=args.device) == PfacStatus.SUCCESS
    h = handle[0]

    status = capi.PFAC_readPatternFromFile(h, args.patterns)
    if status != PfacStatus.SUCCESS:
        print(f"Error: fails to read pattern from file, "
              f"{capi.PFAC_getErrorString(status)}")
        return 1

    with open(args.table, "w") as fp:
        capi.PFAC_dumpTransitionTable(h, fp)

    with open(args.input, "rb") as f:
        data = f.read()
    input_size = len(data)
    matched_result = np.zeros(input_size, dtype=np.int32)

    status = capi.PFAC_matchFromHost(h, data, input_size, matched_result)
    if status != PfacStatus.SUCCESS:
        print(f"Error: fails to PFAC_matchFromHost, "
              f"{capi.PFAC_getErrorString(status)}")
        return 1

    print("position |  matched pattern ID")
    for i in range(input_size):
        if matched_result[i] != 0:
            print("%5d    %5d" % (i, matched_result[i]))

    capi.PFAC_destroy(h)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
