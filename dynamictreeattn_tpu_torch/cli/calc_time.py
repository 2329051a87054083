"""Cross-bin timing aggregator: group stats records by their ``…_bin{k}``
prefix, take each group's time as the max over its bins (the K-device
makespan), print the total time and tokens/s.

Counterpart of ``dynamictreeattn_tpu/cli/calc_time.py`` (the same text):

    python -m dynamictreeattn_tpu_torch.cli.calc_time --stats stats/dp.jsonl
"""

from __future__ import annotations

import argparse
import json
import re


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stats", required=True)
    args = p.parse_args(argv)

    with open(args.stats) as f:
        recs = [json.loads(line) for line in f if line.strip()]

    groups: dict[str, dict] = {}
    for r in recs:
        if "file" not in r or "time" not in r:
            continue
        m = re.match(r"(.+)_bin(\d+)(\.\w+)?$", r["file"])
        key = m.group(1) if m else r["file"]
        g = groups.setdefault(key, {"max_time": 0.0, "n_tokens": 0, "bins": 0})
        g["max_time"] = max(g["max_time"], float(r["time"]))
        g["n_tokens"] += int(r.get("n_tokens", 0))
        g["bins"] += 1

    total_time = sum(g["max_time"] for g in groups.values())
    total_tokens = sum(g["n_tokens"] for g in groups.values())
    for key, g in sorted(groups.items()):
        print(json.dumps({"group": key, **g}))
    print(json.dumps({
        "aggregate": True,
        "total_time": total_time,
        "total_tokens": total_tokens,
        "tokens_per_s": total_tokens / total_time if total_time else 0.0,
    }))


if __name__ == "__main__":
    main()
