"""Guidance-config parsing: every rule of the library reachable from the CLI
(port of `cld_tpu/guidance/parsing.py`).

Guidance is a list of {"name", "weight", "params", "agents"} dicts. The CLI
accepts

* inline JSON:      --guidance '[{"name": "speed_limit", "params": {...}}]'
* a JSON/YAML file: --guidance @my_edits.json
* shorthand:        --guidance 'speed_limit:15,agent_collision'

Per-agent parameters (target_speed, target_pos, ...) given as scalars or
single rows are broadcast to the agent count; `agents` becomes the
GuidanceSpec's static agent mask.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from cld_tpu_torch.guidance.losses import GUIDANCE_LOSS_MAP
from cld_tpu_torch.guidance.perturbation import GuidanceSpec

# shorthand "name:value" -> the parameter the value binds to
_SHORTHAND_PARAM = {
    "speed_limit": ("speed_limit", float),
    "acc_limit": ("acc_limit", float),
    "target_speed": ("target_speed", float),
    "lane_following": ("pos_weight", float),
    "agent_collision": None,
    "map_collision": None,
}

# per-agent array parameters: rule -> {param: (trailing shape, dtype)}
_PER_AGENT_PARAMS = {
    "target_speed": {"target_speed": ((), np.float32)},
    "target_pos_at_time": {"target_pos": ((2,), np.float32), "target_time": ((), np.int64)},
    "target_pos": {"target_pos": ((2,), np.float32)},
    "global_target_pos_at_time": {
        "target_pos_world": ((2,), np.float32),
        "target_time": ((), np.int64),
        "urgency": ((), np.float32),
    },
    "global_target_pos": {"target_pos_world": ((2,), np.float32), "urgency": ((), np.float32)},
    "stop_sign": {"stop_sign_pos": ((2,), np.float32), "stop_box_dim": ((2,), np.float32)},
    "global_stop_sign": {"stop_sign_pos": ((2,), np.float32),
                         "stop_box_dim": ((2,), np.float32)},
}

# the reference's parameter names -> the rules' field names
_PARAM_ALIASES = {
    "stop_sign": {"stop_box_center": "stop_sign_pos"},
    "global_target_pos_at_time": {"target_pos": "target_pos_world"},
    "global_target_pos": {"target_pos": "target_pos_world"},
    "gptcollision": {"target_ind": "attacker_ind", "ref_ind": "victim_ind"},
    "collision_attack": {"target_ind": "attacker_ind", "ref_ind": "victim_ind"},
    # without these the unknown-parameter filter would drop them quietly and
    # run with the 5 / 15 defaults
    "keep_distance": {"min_distance": "min_dist", "max_distance": "max_dist"},
    "gptkeepdistance": {"min_distance": "min_dist", "max_distance": "max_dist"},
}


def _load_file(path: str):
    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            try:
                import yaml
            except ImportError as e:
                raise RuntimeError(
                    f"reading {path} needs PyYAML, which is not installed; give the guidance "
                    "as a .json file or inline JSON instead"
                ) from e
            return yaml.safe_load(f)
        return json.load(f)


def parse_guidance_arg(spec: str) -> List[Dict]:
    """CLI string -> list of guidance config dicts."""
    spec = (spec or "").strip()
    if not spec:
        return []
    if spec.startswith("@"):
        loaded = _load_file(spec[1:])
        return loaded if isinstance(loaded, list) else [loaded]
    if spec[0] in "[{":
        loaded = json.loads(spec)
        return loaded if isinstance(loaded, list) else [loaded]
    configs = []
    for item in spec.split(","):
        name, _, val = item.partition(":")
        name = name.strip()
        if name not in GUIDANCE_LOSS_MAP:
            raise ValueError(f"unknown guidance rule {name!r}; known: {sorted(GUIDANCE_LOSS_MAP)}")
        params: Dict = {}
        binder = _SHORTHAND_PARAM.get(name)
        if val and binder:
            pname, cast = binder
            params[pname] = cast(val)
        elif val:
            # a value on a rule without a binder would otherwise run with
            # the defaults while the user believes it applied
            raise ValueError(f"rule {name!r} has no shorthand value; use JSON params")
        configs.append({"name": name, "params": params, "weight": 1.0})
    return configs


def _broadcast_per_agent(name: str, params: Dict, num_agents: int) -> Dict:
    """Scalars / single rows -> per-agent arrays where the rule takes [B]."""
    spec = _PER_AGENT_PARAMS.get(name)
    if not spec:
        return params
    out = dict(params)
    for pname, (trailing, dtype) in spec.items():
        if pname not in out:
            continue
        arr = np.asarray(out[pname], dtype=dtype)
        want_ndim = 1 + len(trailing)
        if arr.ndim < want_ndim or (arr.ndim == want_ndim and arr.shape[0] == 1):
            arr = np.broadcast_to(arr, (num_agents, *trailing)).copy()
        out[pname] = arr
    return out


def specs_from_configs(configs: Sequence[Dict], num_agents: int) -> List[GuidanceSpec]:
    """Guidance config dicts -> GuidanceSpec list. `agents` (a list of
    indices) becomes a static bool mask; parameters a rule does not carry
    are dropped."""
    specs: List[GuidanceSpec] = []
    for cfg in configs:
        name = cfg["name"]
        cls = GUIDANCE_LOSS_MAP[name]
        params = dict(cfg.get("params", {}))
        for old, new in _PARAM_ALIASES.get(name, {}).items():
            if old in params and new not in params:
                params[new] = params.pop(old)
        known = {f.name for f in dataclasses.fields(cls)}
        params = {k: v for k, v in params.items() if k in known}
        params = _broadcast_per_agent(name, params, num_agents)
        agents: Optional[Sequence[int]] = cfg.get("agents")
        mask = None
        if agents is not None:
            m = np.zeros(num_agents, bool)
            m[np.asarray(agents, int)] = True
            mask = tuple(bool(b) for b in m)
        try:
            loss = cls(**params)
        except TypeError as e:
            raise ValueError(
                f"guidance rule {name!r} is missing required params ({e}); bind them via "
                f"shorthand ('{name}:VALUE'), JSON params, or use --editing-source heuristic "
                "for state-derived targets"
            ) from e
        specs.append(GuidanceSpec(loss, float(cfg.get("weight", 1.0)), mask))
    return specs
