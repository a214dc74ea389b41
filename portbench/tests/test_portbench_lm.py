"""``lib/lm.arch_config``: every key of a configuration file that names a
field of the port's ``ArchConfig``, ``SSMConfig`` or ``MoEConfig``
reaches the port; the descriptive keys stay behind; any other key
raises."""
import json
import pathlib

import pytest

pytest.importorskip("torch")

from portbench.lib import lm as lmlib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[2]
INTERNLM2 = json.loads((ROOT / "portbench/configs/internlm2-1.8b.json")
                       .read_text())


def _by_the_old_key_lists(cfg: dict):
    """``arch_config`` as it read a file before every key passed: eleven
    top-level keys, the pattern, five keys of ``ssm``."""
    from repro_torch.configs.base import ArchConfig, SSMConfig
    kw = {k: cfg[k] for k in (
        "name", "family", "num_layers", "d_model", "num_heads",
        "num_kv_heads", "d_ff", "vocab_size", "norm_eps", "rope_theta",
        "param_dtype")}
    kw["block_pattern"] = tuple(cfg["block_pattern"])
    if cfg.get("ssm"):
        kw["ssm"] = SSMConfig(**{k: cfg["ssm"][k] for k in (
            "kind", "state_dim", "head_dim", "expand", "conv_width")})
    return ArchConfig(**kw)


def test_internlm2_is_configured_as_before():
    got = lmlib.arch_config(INTERNLM2)
    assert got == _by_the_old_key_lists(INTERNLM2)
    assert got.source == "" and got.block_pattern == ("attn",)


WIDE = {
    "name": "wide", "family": "hybrid", "source": "a test", "context": 64,
    "reduced": [], "assumed": {"x": "y"}, "deployment": "none",
    "num_layers": 4, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
    "d_head": 24, "d_ff": 128, "vocab_size": 256, "tie_embeddings": True,
    "qk_norm": True, "sliding_window": 16, "mrope_sections": [2, 4, 6],
    "block_pattern": ["mamba", "moe"],
    "moe": {"num_experts": 8, "top_k": 2, "d_ff_expert": 32,
            "num_shared_experts": 1},
    "ssm": {"kind": "mamba2", "state_dim": 16, "head_dim": 32, "expand": 2,
            "conv_width": 4, "dt_rank": 3, "decay_lora": 5},
}


def _wide() -> dict:
    """``WIDE`` as a file reads, with the program's decay clamp."""
    from repro_torch.models import gla
    cfg = json.loads(json.dumps(WIDE))
    cfg["ssm"]["log_decay_clamp"] = gla.LOG_DECAY_CLAMP
    return cfg


def test_every_field_gets_through():
    got = lmlib.arch_config(_wide())
    assert (got.d_head, got.head_dim, got.tie_embeddings, got.qk_norm,
            got.sliding_window) == (24, 24, True, True, 16)
    assert got.block_pattern == ("mamba", "moe")
    assert got.mrope_sections == (2, 4, 6)
    assert (got.moe.num_experts, got.moe.top_k, got.moe.d_ff_expert,
            got.moe.num_shared_experts) == (8, 2, 32, 1)
    assert (got.ssm.kind, got.ssm.state_dim, got.ssm.head_dim,
            got.ssm.expand, got.ssm.conv_width, got.ssm.dt_rank,
            got.ssm.decay_lora) == ("mamba2", 16, 32, 2, 4, 3, 5)
    assert got.source == ""                      # descriptive, left out
    hash(got)                                    # frozen, tuples only


@pytest.mark.parametrize("where, key", [
    ("", "num_kv_head"), ("", "head_dim"), ("ssm", "state_dims"),
    ("moe", "topk")])
def test_a_misspelled_key_raises(where, key):
    cfg = _wide()
    (cfg[where] if where else cfg)[key] = 1
    name = f"{where}.{key}" if where else key
    with pytest.raises(ValueError, match=repr(name).replace(".", r"\.")):
        lmlib.arch_config(cfg)


def test_a_clamp_other_than_the_program_s_raises():
    cfg = _wide()
    cfg["ssm"]["log_decay_clamp"] = -1.0
    with pytest.raises(ValueError, match="clamps the log decay"):
        lmlib.arch_config(cfg)
