"""Render dry-run JSONL reports into roofline tables (port of
``repro.roofline.report``; rows without ``memory_fused_ms`` show the
memory term in its column)."""
from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List


def load(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def fmt_table(rows: List[dict], caption: str) -> str:
    hdr = ("| arch | shape | mesh | compute ms | memory ms | memF ms | "
           "coll ms | dominant | peak GB/dev | useful FLOPs | "
           "coll GB/dev |\n"
           "|---|---|---|---:|---:|---:|---:|---|---:|---:|---:|\n")
    out = [f"**{caption}**\n\n", hdr]
    for r in rows:
        memf = r.get("memory_fused_ms", r["memory_ms"])
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']}"
            f"{'+fl' if r.get('fl') else ''} | {r['compute_ms']:.1f} | "
            f"{r['memory_ms']:.1f} | {memf:.1f} | "
            f"{r['collective_ms']:.1f} | "
            f"{r['dominant']} | {r['hbm_gb_per_dev']:.1f} | "
            f"{r['model_flops_frac']:.3f} | "
            f"{r['collective_gb_per_dev']:.2f} |\n")
    return "".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("files", nargs="+")
    ap.add_argument("--caption", default=None)
    args = ap.parse_args()
    for path in args.files:
        rows = load(path)
        caption = args.caption or os.path.basename(path)
        print(fmt_table(rows, caption))


if __name__ == "__main__":
    main()
