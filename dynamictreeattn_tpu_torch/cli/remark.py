"""Stats re-annotator: rewrite a stats JSONL, recomputing the trie cost
features from the data files with the proper permute (to refit the
TreeTimeModel on past runs).

Counterpart of ``dynamictreeattn_tpu/cli/remark.py`` (the same output):

    python -m dynamictreeattn_tpu_torch.cli.remark --stats stats/tree.jsonl \
        --data-dir data/tau2 --out stats/tree.remarked.jsonl
"""

from __future__ import annotations

import argparse
import json
import os

from dynamictreeattn_tpu_torch.data.io import load_sequences
from dynamictreeattn_tpu_torch.tries import TokenTrie, trie_stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stats", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--block-size", type=int, default=None,
                   help="override block size (default: from each record)")
    args = p.parse_args(argv)

    with open(args.stats) as f:
        recs = [json.loads(line) for line in f if line.strip()]

    out = []
    for r in recs:
        if "file" not in r or "run" not in r:
            out.append(r)
            continue
        path = os.path.join(args.data_dir, r["file"])
        if not os.path.exists(path):
            out.append(r)
            continue
        seqs = load_sequences(path)
        mode = "backward" if r["run"].endswith("backward") else "forward"
        trie = TokenTrie(seqs, [{} for _ in seqs])
        if mode == "backward":
            trie.backward_permute()
        else:
            trie.forward_permute()
        bs = args.block_size or r.get("block_size", 2048)
        r = dict(r, **trie_stats(trie.lens, trie.lcp_lens, mode=mode, block_size=bs))
        out.append(r)

    with open(args.out, "w") as f:
        for r in out:
            f.write(json.dumps(r) + "\n")
    print(f"re-annotated {len(out)} records -> {args.out}")


if __name__ == "__main__":
    main()
