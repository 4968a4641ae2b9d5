"""YAML config loading with recursive BASE inheritance.

Parity with reference config_loaders.py:9-70: a config may name a parent
file under the ``BASE`` key (path relative to the child); parents load all
the way to the root and children deep-merge over them.
"""

from __future__ import annotations

import os

__all__ = ["read_yaml", "merge_dicts", "load_config"]


def read_yaml(path):
    import yaml  # only the descriptor/recipe readers need PyYAML

    with open(path, mode="r") as handle:
        return yaml.safe_load(handle)


def merge_dicts(dict1, dict2):
    """Recursively merge dict2 into dict1 (in place), dict2 wins."""
    for k, v in dict2.items():
        if isinstance(v, dict) and isinstance(dict1.get(k), dict):
            merge_dicts(dict1[k], v)
        else:
            dict1[k] = v
    return dict1


def load_config(config_file, base_kw="BASE"):
    """Load a YAML config, resolving the BASE inheritance chain."""
    chain = []
    path = config_file
    seen = set()
    while True:
        config = read_yaml(path)
        chain.append(config)
        if base_kw not in config:
            break
        base_path = os.path.join(
            os.path.abspath(os.path.dirname(path)), config[base_kw])
        if base_path in seen:
            raise ValueError(f"circular BASE inheritance at {base_path}")
        seen.add(base_path)
        path = base_path

    merged = chain[-1]
    for config in chain[-2::-1]:
        merged = merge_dicts(merged, config)
    return merged
