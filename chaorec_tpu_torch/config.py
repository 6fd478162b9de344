"""Configuration: one explicit config object and the YAML cartesian grid.

Counterpart of ``chaorec_tpu/config.py``: the same ``Config`` fields and
defaults, the same grid semantics and the same CLI flags, so a command line
or a ``Model_YAML/*.yaml`` grid means the same thing to both packages.

YAML schema (``Model_YAML/*.yaml``): ``{param: [v1, v2, ...],
hyper_parameters: [axis names]}``; only keys listed in ``hyper_parameters``
become grid axes, and axis values overwrite the config attribute for that
combination, including keys that are not predeclared fields (they land in
``Config.extra``).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple


@dataclass
class Config:
    """All run-time flags, with the JAX package's defaults."""

    Model: str = "COHESION"
    data_path: str = "microlens"
    learning_rate: float = 1e-3
    feature_embed: int = 64
    batch_size: int = 1024
    aggr_mode: str = "add"
    reg_weight: float = 1e-3
    dim_E: int = 64
    num_epoch: int = 1000
    dropout: float = 0.2
    n_layers: int = 2
    corDecay: float = 0.001
    n_factors: int = 4
    n_iterations: int = 3
    cl_weight: float = 2.0
    mm_layers: int = 2
    ii_topk: int = 10
    uu_topk: int = 10
    lambda_coeff: float = 0.9
    ssl_temp: float = 0.9
    ssl_alpha: float = 0.9
    ae_weight: float = 0.1
    threshold: float = 0.1
    prompt_num: float = 0.1
    neg_weight: float = 0.1
    cen_reg: float = 5e-3
    n_intents: int = 128
    G_rate: float = 1e-4
    align_weight: float = 0.1
    mask_weight_f: float = 1.5
    mask_weight_g: float = 0.001
    leaky: float = 0.5
    keepRate: float = 1.0
    mult: float = 0.1
    grid_size: int = 1
    node_dropout: float = 0.1
    message_dropout: float = 0.1
    n_mca: int = 2
    gamma: float = 0.5
    t: float = 1.8
    e_loss: float = 0.1
    ris_lambda: float = 0.5
    rebuild_k: int = 1
    pnn_layer: int = 1
    b2: float = 1.0
    ctra: float = 0.001
    noise_alpha: float = 0.3
    ssl_temp2: float = 0.2
    K_s: int = 1
    T_s: float = 1.0
    K_b: int = 1
    T_b: float = 1.0
    idl_beta: float = 1.0
    sampling_noise: bool = False
    sampling_steps: int = 0
    steps: int = 5
    noise_scale: float = 0.1
    noise_min: float = 0.0001
    noise_max: float = 0.02
    dims: str = "[1000]"
    h_layers: int = 2
    num_hypernodes: int = 10
    beta1: float = 0.5
    beta2: float = 0.5
    n_ui_layers: int = 3
    um_loss: float = 0.1
    vt_loss: float = 0.1
    seed: int = 42
    num_workers: int = 1
    topk: Tuple[int, ...] = (5, 10, 20)

    # Keys that the reference sets only from YAML files; declared so that a
    # grid overwrite is typed.
    mm_image_weight: float = 0.1

    # Framework settings with no reference counterpart. Some of them only
    # mean something to the JAX package's trainer; they are kept so that one
    # command line parses the same in both packages.
    data_root: str = "Data"  # directory containing {dataset}/train.npy etc.
    log_dir: str = "log"
    rank_topk: int = 50
    patience: int = 20
    neg_candidates: int = 8
    eval_user_chunk: int = 4096  # users scored per export/eval chunk
    dense_prop_threshold: int = 600_000_000
    graph_compute_dtype: str = "bfloat16"
    relaxed_precision: str = ""
    max_dispatch_batches: int = 0
    mesh_shape: str = ""
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    profile_dir: str = ""
    export_artifact: str = ""
    eval_pipeline: bool = True

    # Extra dynamic keys from YAML that are not predeclared.
    extra: Dict[str, Any] = field(default_factory=dict)

    def replace(self, **kwargs: Any) -> "Config":
        """Immutable update; unknown keys land in ``extra``.

        YAML 1.1 parses dot-less scientific notation ("1e-5") as a string;
        string values are coerced to the field's numeric type so grid
        combos behave like typed CLI flags."""
        known = {f.name for f in dataclasses.fields(self)}
        direct = {k: v for k, v in kwargs.items() if k in known}
        unknown = {k: v for k, v in kwargs.items() if k not in known}
        for k, v in list(direct.items()):
            cur = getattr(self, k)
            if isinstance(v, str) and isinstance(cur, (int, float)) \
                    and not isinstance(cur, bool):
                try:
                    fv = float(v)
                except ValueError:
                    continue
                if isinstance(cur, int) and not fv.is_integer():
                    raise ValueError(
                        f"config field {k!r} is an int; refusing to "
                        f"truncate string value {v!r}"
                    )
                direct[k] = type(cur)(fv)
        new = dataclasses.replace(self, **direct)
        if unknown:
            new.extra = {**self.extra, **unknown}
        return new

    def get(self, key: str, default: Any = None) -> Any:
        if hasattr(self, key) and key != "extra":
            return getattr(self, key)
        return self.extra.get(key, default)

    def as_flat_dict(self) -> Dict[str, Any]:
        d = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        d.pop("extra")
        d.update(self.extra)
        return d


def load_yaml_config(model_name: str, yaml_dir: str = "Model_YAML") -> Dict[str, Any]:
    """Read ``{yaml_dir}/{model_name}.yaml``.

    PyYAML is imported here and not at the top: a machine that only serves
    has no need of it, and may not have it."""
    import yaml

    yaml_file = Path(yaml_dir) / f"{model_name}.yaml"
    with open(yaml_file, "r") as fh:
        return yaml.safe_load(fh)


def grid_combinations(yaml_cfg: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
    """Cartesian product over the ``hyper_parameters`` axes."""
    axes: List[str] = yaml_cfg["hyper_parameters"]
    values = [yaml_cfg[a] for a in axes]
    for combo in itertools.product(*values):
        yield dict(zip(axes, combo))


def parse_cli(argv: Optional[List[str]] = None) -> Config:
    """The JAX package's command-line flags, one per ``Config`` field."""
    parser = argparse.ArgumentParser(description="Run ChaoRec on PyTorch.")
    cfg = Config()
    skip = {"topk", "extra"}
    for f in dataclasses.fields(Config):
        if f.name in skip:
            continue
        default = getattr(cfg, f.name)
        if isinstance(default, bool):
            parser.add_argument(f"--{f.name}", type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        else:
            parser.add_argument(f"--{f.name}", type=type(default), default=default)
    parser.add_argument("--topk", type=int, nargs="+", default=[5, 10, 20])
    ns = parser.parse_args(argv)
    d = vars(ns)
    d["topk"] = tuple(d["topk"])
    return Config(**d)
