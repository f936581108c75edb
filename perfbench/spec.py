"""The benchmark's data, found by name: ``BENCHMARK.json`` at the checkout's
root, and under ``perfbench/`` one file per configuration
(``configs/<config>.json``), traffic mix (``traffic/<mix>.json``), cell
(``workloads/<cell>.json``) and per-layer metric family
(``metrics/<family>.py``). Adding any of them adds files and entries; no
file here changes.

Nothing in this module imports the program: a configuration is turned into
the program's ``ModelConfig`` keyword arguments here, and into the object
by the harness.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

# the source's config.json keys -> the program's ModelConfig fields
_MODEL_KEYS = {
    "num_hidden_layers": "num_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "vocab_size": "vocab_size",
    "head_dim": "head_dim",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "tie_word_embeddings": "tie_embeddings",
    "max_position_embeddings": "max_position_embeddings",
    "num_experts": "num_experts",
    "num_experts_per_tok": "num_experts_per_tok",
    "moe_intermediate_size": "moe_d_ff",
    "qk_norm": "qk_norm",
    "torch_dtype": "param_dtype",
}
ENGINE_KEYS = ("block_size", "max_num_seqs", "max_prefill_tokens",
               "max_model_len", "num_blocks", "enable_prefix_caching")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclass
class Cell:
    """One cell, everything the harness needs, read from the files."""
    name: str
    chips: int
    config_name: str
    config: dict          # configs/<config>.json
    traffic_name: str
    traffic: dict         # traffic/<mix>.json
    params: dict          # workloads/<cell>.json
    end_to_end: list      # BENCHMARK.json end_to_end entries this cell reports
    per_layer: list       # BENCHMARK.json per_layer entries this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``; KeyError if there is none."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"], config_name=entry["config"],
        config=load_json(root / conf["file"]),
        traffic_name=entry["traffic"],
        traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
        params=load_json(here / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)])


def model_kwargs(config: dict, name: str) -> dict:
    """The program's ModelConfig keyword arguments for a configuration
    file: the source's keys renamed, the feed-forward width taken from
    ``intermediate_size`` (dense) or ``moe_intermediate_size`` (moe)."""
    kw = {"name": name, "family": config["family"]}
    for key, field in _MODEL_KEYS.items():
        if key in config:
            kw[field] = config[key]
    kw["d_ff"] = config["moe_intermediate_size" if config["family"] == "moe"
                        else "intermediate_size"]
    return kw


def engine_kwargs(config: dict) -> dict:
    return {k: config[k] for k in ENGINE_KEYS}


def metric_reader(name: str, here: Path = HERE):
    """The reader of a per-layer metric: ``metrics/<family>.py``'s ``read``,
    the family being the name up to its first dot."""
    family = name.split(".")[0]
    path = here / "metrics" / f"{family}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{family}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read
