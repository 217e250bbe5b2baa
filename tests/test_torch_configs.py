"""``chip_smoke.py`` builds the four configs the repo ships inline (it may
not import JAX, so not the YAML loader): each must equal
``video_stab_tpu.utils.config.load_config(configs/<name>.yaml)`` field for
field, section by section."""

import dataclasses
import os
import sys

import pytest

pytest.importorskip("torch")

from video_stab_tpu.utils.config import load_config  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

SECTIONS = (("mode", "mode"), ("enhancer", "enhancer"),
            ("roll", "roll_correction"), ("stabilizer", "stabilizer"),
            ("azc", "auto_zoom_crop"))


def test_every_shipped_config_is_built():
    names = sorted(f[:-5] for f in os.listdir(os.path.join(REPO, "configs"))
                   if f.endswith(".yaml"))
    assert sorted(chip_smoke.shipped_configs()) == names


@pytest.mark.parametrize("name", ["default", "drone_hf", "rtsp_serving",
                                  "selftest"])
def test_inline_config_equals_yaml(name):
    inline = chip_smoke.shipped_configs()[name]
    cfg = load_config(os.path.join(REPO, "configs", f"{name}.yaml"))
    for ours, theirs in SECTIONS:
        assert dataclasses.asdict(inline[ours]) == \
            dataclasses.asdict(getattr(cfg, theirs)), (name, ours)
    assert inline["fuse_roll"] == cfg.roll_fusion
