"""The serving knee from a sweep of `series.py --rate` runs: the highest
offered rate at which no backlog builds over the window: the median
latency of the window's first fifth and of its last fifth of requests
both stay within twice the lowest rate's, every lower rate holding as
well.

    python3 benchmark/tools/knee.py chiprun_out/sweep.jsonl
"""

import json
import re
import sys


def knee(path):
    rows = []
    for line in open(path):
        r = json.loads(line)
        m = re.search(r"at ([\d.]+)/s.*first fifth ([\d.]+) ms, of the last "
                      r"fifth ([\d.]+) ms", r["stderr"])
        p95 = (r["result"] or {}).get("metrics", {}).get("serve_p95_ms", {})
        rows.append((float(m.group(1)), float(m.group(2)),
                     float(m.group(3)), p95.get("value")))
    rows.sort()
    best = None
    base = min(rows[0][1], rows[0][2])
    for rate, head, tail, p95 in rows:
        stable = max(head, tail) <= 2 * base
        print(f"rate {rate:g}/s: p95 {p95} ms, latency p50 first fifth "
              f"{head} ms, last fifth {tail} ms, "
              f"{'holds' if stable else 'backlog grows'}")
        if not stable:
            break
        best = rate
    return best


if __name__ == "__main__":
    print("knee", knee(sys.argv[1]))
