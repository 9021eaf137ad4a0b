"""Finding a cell's files by name, and what every run shares.

A cell ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and traffic mix (``traffic/<traffic>.json``),
whose ``kind`` names the loop ``loops/<kind>.py``; its metrics are
``metrics/<metric>.py`` and the kernel groups the trace sorts device time
into are ``kernels/<group>.json``.  Adding any of them adds a file and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Pattern, Tuple

ROOT = Path(__file__).resolve().parent

#: top-level module names no run may have loaded when its window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "amq_tpu")


def _json(root: Path, kind: str, name: str) -> dict:
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise KeyError(f"no {kind} file named {name!r} under {root}")
    return json.loads(path.read_text())


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with its configuration and traffic mix loaded
    (keys ``config_data`` and ``traffic_data``)."""
    w = _json(root, "workloads", name)
    return dict(w, name=name, root=str(root),
                config_data=_json(root, "configs", w["config"]),
                traffic_data=_json(root, "traffic", w["traffic"]))


def module(root: Path, kind: str, name: str) -> ModuleType:
    """``<root>/<kind>/<name>.py`` loaded by its path (names may hold
    dots)."""
    path = Path(root) / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} file named {name!r} under {root}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_groups(root: Path = ROOT) -> List[Tuple[str, List[Pattern]]]:
    """``[(group, patterns)]`` of every ``kernels/<group>.json``, by name."""
    out = []
    for path in sorted(Path(root, "kernels").glob("*.json")):
        spec = json.loads(path.read_text())
        out.append((path.stem, [re.compile(p) for p in spec["patterns"]]))
    return out


def group_rows(root: Path, group: str) -> Tuple[int, int]:
    """The rows (M) of the products the kernel group ``group`` serves."""
    lo, hi = _json(Path(root), "kernels", group)["rows"]
    return lo, hi


def group_seconds(trace, group: str, *shared: str) -> float:
    """Device seconds of the kernel group ``group`` in ``trace`` (a
    summary), with those of the groups ``shared`` added; 0 when the group
    took none."""
    got = (trace or {}).get("group_s", {})
    if not got.get(group):
        return 0.0
    return got[group] + sum(got.get(g, 0.0) for g in shared)


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are in :data:`FORBIDDEN`,
    compared whole (``amq_tpu_torch`` is not ``amq_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def read_metrics(names: List[str], run, root: Path = ROOT) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read in ``run``."""
    out = {}
    for name in names:
        m = module(root, "metrics", name)
        value = m.read(run)
        if value is not None:
            out[name] = {"value": value, "unit": m.UNIT}
    return out
