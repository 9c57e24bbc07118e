"""Tiny cells for the CPU tests: the benchmark's own configurations and
cells with their widths cut, written as files into a directory laid out
as ``bench/`` is (``configs/``, ``workloads/``, ``metrics/``), with a
manifest that names them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

CELLS = {
    # cell: (its source cell, config edits, cell edits)
    "tiny_round": ("cnn_sampled_round",
                   {"model": dict(conv_channels=[4, 4, 8, 8],
                                  dense_hidden=[16, 8]),
                    "codec": dict(chunk_size=256, hidden=[32]),
                    "fl": dict(batch_size=8)},
                   dict(n_clients=12, cohort=4, shard=16, local_epochs=2,
                        eval=8)),
    "tiny_lm_round": ("stablelm_delta_round",
                      {"model": dict(n_layers=2, d_model=64, n_heads=4,
                                     n_kv_heads=4, head_dim=16, d_ff=128,
                                     vocab_size=512)},
                      # two layers of 64 wide move further apart from
                      # seed to seed than the cell's model does
                      dict(seqs=4, seq_len=32,
                           limits={"first_update": 1e-2})),
    "tiny_ingest": ("cnn_ingest_k4096",
                    {"model": dict(conv_channels=[4, 4, 8, 8],
                                   dense_hidden=[16, 8], n_params=8000),
                     "codec": dict(chunk_size=256, hidden=[32])},
                    {"traffic_params": dict(n_clients=2000, buffer_k=64)}),
}


def load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def write(directory: Path, cells=tuple(CELLS)) -> dict:
    """Write the tiny cells (and their configurations) under
    ``directory``, copy the metric readers, and return the manifest that
    names them in place of the cells they were cut from."""
    for sub in ("configs", "workloads"):
        (directory / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(BENCH / "metrics", directory / "metrics",
                    dirs_exist_ok=True)
    manifest = load(ROOT / "BENCHMARK.json")
    renames = {}
    for name in cells:
        source, cfg_edits, cell_edits = CELLS[name]
        cell = load(BENCH / "workloads" / f"{source}.json")
        config = load(BENCH / "configs" / f"{cell['config']}.json")
        for key, edits in cfg_edits.items():
            config[key] = dict(config[key], **edits)
        config["name"] = f"tiny_{cell['config']}_{name}"
        for key, v in cell_edits.items():
            cell[key] = dict(cell[key], **v) if isinstance(v, dict) else v
        cell.update(name=name, config=config["name"])
        with open(directory / "configs" / f"{config['name']}.json",
                  "w") as f:
            json.dump(config, f)
        with open(directory / "workloads" / f"{name}.json", "w") as f:
            json.dump(cell, f)
        renames[source] = name
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [renames.get(w, w) for w in m["workloads"]]
    for w in manifest["workloads"]:
        w["name"] = renames.get(w["name"], w["name"])
    return manifest
