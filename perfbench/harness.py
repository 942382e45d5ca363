"""The benchmark's harness: finds a cell's files by name, runs its entry,
reads its per-layer metrics and prints the result line.

Everything that belongs to one cell, configuration, traffic mix or metric
is a file of its own, found by the name in ``BENCHMARK.json``:

- ``perfbench/workloads/<cell>.json``: the entry that drives it, its
  weights and the limits of its correctness numbers;
- the configuration's ``file`` (``perfbench/configs/<config>.json``);
- ``perfbench/traffic/<traffic>.json``: the traffic mix's parameters;
- ``perfbench/entries/<entry>.py``: a class ``Entry`` (set-up in its
  constructor, then ``window``, ``release`` and ``check``);
- ``perfbench/metrics/<metric>.py``: ``read(obs)``, a number or None.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "grain", "tensorflow",
             "ppn_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    cfg: dict          # the configuration file
    traffic: dict      # the traffic mix's parameters
    work: dict         # the cell's own file
    device: Any = None
    program: str = "program"   # "fp8": the reference in fp8 in its place
    workers: int = 8           # processes that render the images


def find_cell(name: str, man: dict, bench: Path = BENCH) -> dict:
    """The cell's manifest entry with its three files loaded."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    return {"manifest": w,
            "cfg": load_json(bench.parent / configs[w["config"]]["file"]),
            "traffic": load_json(bench / "traffic" / f"{w['traffic']}.json"),
            "work": load_json(bench / "workloads" / f"{name}.json")}


def entry_class(name: str):
    return importlib.import_module(f"perfbench.entries.{name}").Entry


def metric_reader(name: str, bench: Path = BENCH):
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it, or, without a list, those whose end-to-end metric
    (``moves``, or the metric itself) the cell reports."""
    e2e = {m["name"]: m for m in man["end_to_end"]}

    def has(m: dict) -> bool:
        if "workloads" in m:
            return cell in m["workloads"]
        if kind == "per_layer":
            return has(e2e[m["moves"]])
        return True

    return [m for m in man[kind] if has(m)]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi gave nothing"


def program_config(cfg: dict):
    """The program's named configuration, held to the file: every value the
    file states for a field the program has must be the program's."""
    from ppn_tpu_torch.configs import get_config

    pc = get_config(cfg["program_config"])
    bad = []
    for group in ("model", "train", "data"):
        ours = dataclasses.asdict(getattr(pc, group))
        for k, v in cfg[group].items():
            if k in ours and json.loads(json.dumps(ours[k])) != v:
                bad.append(f"{group}.{k}: file {v!r}, program {ours[k]!r}")
    if bad:
        raise ValueError("the program's configuration "
                         f"{cfg['program_config']} is not the file's: "
                         + "; ".join(bad))
    return pc


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number that has a limit beside it; a number passes when it is
    finite and at most its limit. Numbers without a limit are readings
    that the entry reports and nothing compares."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"the entry gave no {missing}")
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def read_per_layer(man: dict, cell: str, obs: dict,
                   bench: Path = BENCH) -> Dict[str, dict]:
    out = {}
    for m in cell_metrics(man, cell, "per_layer"):
        v = metric_reader(m["name"], bench)(obs)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict,
                breakdown: Optional[dict] = None, card: str = "") -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["card"] = card
    out["checks"] = checks
    return json.dumps(out)
