"""Helpers shared by the tests that hold the PyTorch port against the JAX
package."""

import ast
import dataclasses
from pathlib import Path

from lidar_ai_recommendation_software_tpu_torch import config as port_config


def port_cfg(cfg):
    """The port's ``PipelineConfig`` with every field of the JAX package's
    ``cfg`` (one made by ``with_capacity`` included), so both packages run
    the same configuration."""
    fields = dataclasses.asdict(cfg)
    default = port_config.PipelineConfig()
    kw = {}
    for f in dataclasses.fields(port_config.PipelineConfig):
        sub = getattr(default, f.name)
        kw[f.name] = (type(sub)(**fields[f.name])
                      if dataclasses.is_dataclass(sub) else fields[f.name])
    return port_config.PipelineConfig(**kw)


def imported_modules(path: Path) -> set:
    """Every module a Python file imports, at any depth (function bodies
    too), read with ``ast``."""
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names
