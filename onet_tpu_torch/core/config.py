"""Config system: YAML per-dataset sections + CLI overrides
(``onet_tpu/core/config.py``).

Schema parity with the reference (configs/config_tip2022_20230411.py:15-43,
configs/train_onet_20250407.yml): ``generate_config(yml, dataset_name)``
loads the named YAML section into a namespace; declared CLI flags override
YAML values; everything else passes through untouched so reference YAML
files load as-is. ``device`` is ``core/device.py``'s: "cuda" where a card
is present, else "cpu"; ``nocuda`` follows it. The package ships its own
copy of the workloads' YAML, ``configs/onet.yml`` (``DEFAULT_CONFIG``).
"""

from __future__ import annotations

import argparse
import json
import os
from types import SimpleNamespace
from typing import Optional, Sequence

import torch

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "onet.yml")

# The reference declares exactly these CLI flags (:25-29).
_CLI_FLAGS = (
    ("--enc_in_channels", int, "depth of channels in the first encoder layer"),
    ("--outc_channels", int, "depth of channels at the decoder end"),
    ("--layer_type", str, "type of layer"),
    ("--feature_src", str, "feature source: 'enc' or 'dec'"),
    ("--enc_depth", int, "number of encoder layers"),
)


def _device_name() -> str:
    """The device the entry points default to: "cuda" with a card, else
    "cpu" (the reference's ``torch.cuda.is_available()`` test)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _section(conf_yml: str, dataset: str) -> dict:
    import yaml

    with open(conf_yml) as fp:
        return yaml.safe_load(fp)[dataset]


def setup_config(conf_yml: str, dataset: str = "zy3",
                 argv: Optional[Sequence[str]] = None) -> SimpleNamespace:
    section = _section(conf_yml, dataset)

    parser = argparse.ArgumentParser()
    for flag, typ, help_txt in _CLI_FLAGS:
        parser.add_argument(flag, type=typ, help=help_txt)
    ns = parser.parse_args([] if argv is None else list(argv))

    config = SimpleNamespace(**vars(ns))
    for key, val in section.items():
        if getattr(config, key, None) is not None:
            continue  # CLI wins over YAML
        setattr(config, key, val)
    config.device = _device_name()
    config.nocuda = config.device == "cpu"
    return config


def setup_config_iic(conf_yml: str, dataset: str = "iic") -> SimpleNamespace:
    """Legacy IIC/infoseg config path (config_tip2022_20230411.py:46-100).

    Loads the named YAML section wholesale (no CLI flags on this path,
    matching the reference), derives the IIC bookkeeping fields
    (``dataloader_batch_sz``, ``output_k``, ``eval_mode``), and honours the
    pickle-based restart contract with a JSON file instead of a pickle:
    ``save_config_iic`` persists the config to ``out_dir/configs.json`` and a
    restart reloads it. The reference's restart block re-assigns
    ``num_epochs``/``lr_schedule`` from the *reloaded* config (a no-op,
    :84-86); the evident intent is kept instead: the freshly parsed values
    survive the restart.
    """
    config = SimpleNamespace(**_section(conf_yml, dataset))
    config.device = _device_name()
    config.nocuda = config.device == "cpu"

    config.dataloader_batch_sz = int(config.batch_sz / config.num_dataloaders)
    assert config.mode == "IID"
    assert config.output_k_B == config.gt_k
    config.output_k = config.output_k_B  # for eval code
    assert config.output_k_A >= config.gt_k  # sanity
    config.use_doersch_datasets = False
    config.eval_mode = "hung"

    if getattr(config, "restart", False):
        reloaded = os.path.join(config.out_dir, "configs.json")
        print("Loading restarting configs from: %s" % reloaded)
        with open(reloaded) as config_f:
            saved = json.load(config_f)
        fresh_epochs, fresh_sched = config.num_epochs, config.lr_schedule
        config = SimpleNamespace(**saved)
        config.restart = True
        config.num_epochs = fresh_epochs
        config.lr_schedule = fresh_sched
    else:
        config.epoch_acc = []
        config.epoch_avg_subhead_acc = []
        config.epoch_stats = []
        config.epoch_loss_head_A = []
        config.epoch_loss_no_lamb_head_A = []
        config.epoch_loss_head_B = []
        config.epoch_loss_no_lamb_head_B = []
        print("Given configs: %s" % config_to_str(config))
    return config


def save_config_iic(config, out_dir: str) -> str:
    """Persist an IIC config for restart (JSON stand-in for configs.pickle)."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "configs.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(vars(config), fp, indent=1, default=str)
    os.replace(tmp, path)
    return path


def generate_config(yml_file: str, dataset_name: str,
                    argv: Optional[Sequence[str]] = None) -> SimpleNamespace:
    assert os.path.exists(yml_file), yml_file
    # iic-named YAMLs take the legacy IIC path (reference :121-124).
    if "iic" in os.path.basename(yml_file):
        return setup_config_iic(yml_file, dataset=dataset_name)
    return setup_config(yml_file, dataset=dataset_name, argv=argv)


def config_to_str(config) -> str:
    attrs = vars(config)
    lines = "\n".join("%s: %s" % kv for kv in attrs.items())
    return "Config: -----\n" + lines + "\n----------"
