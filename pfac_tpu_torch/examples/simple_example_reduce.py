"""Compacted-output flow of the C library's simple_example_reduce on the
port: space-driven table + matchFromHostReduce -> (position, pattern ID)
pairs.

Run:  python -m pfac_tpu_torch.examples.simple_example_reduce [--device cpu]
(the card by default; the repository's example pattern and input unless
-P / -I name others).
"""
import argparse

import numpy as np

from pfac_tpu_torch.examples.simple_example import INPUT_FILE, PATTERN_FILE
from pfac_tpu_torch.runtime import capi
from pfac_tpu_torch.runtime.handle import PerfMode
from pfac_tpu_torch.status import PfacStatus


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("-P", "--patterns", default=PATTERN_FILE)
    ap.add_argument("-I", "--input", default=INPUT_FILE)
    args = ap.parse_args(argv)

    handle = [None]
    assert capi.PFAC_create(handle, device=args.device) == PfacStatus.SUCCESS
    h = handle[0]
    assert capi.PFAC_setPerfMode(h, PerfMode.HASH) == PfacStatus.SUCCESS

    status = capi.PFAC_readPatternFromFile(h, args.patterns)
    if status != PfacStatus.SUCCESS:
        print(f"Error: {capi.PFAC_getErrorString(status)}")
        return 1

    with open(args.input, "rb") as f:
        data = f.read()

    h_matched = np.zeros(len(data), dtype=np.int32)
    h_pos = np.zeros(len(data), dtype=np.int32)
    h_num = []
    status = capi.PFAC_matchFromHostReduce(
        h, data, len(data), h_matched, h_pos, h_num)
    if status != PfacStatus.SUCCESS:
        print(f"Error: {capi.PFAC_getErrorString(status)}")
        return 1

    n = h_num[0]
    print(f"num_matched = {n}")
    for i in range(n):
        print(f"At position {h_pos[i]:4d}, match pattern {h_matched[i]}")

    capi.PFAC_destroy(h)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
