"""The reference ``state_dict`` key table.

:func:`build_rules` maps every reference parameter name (the keys of
``Model_SPEC2MIDI.state_dict()``) to its path in the JAX package's nested
parameter tree and the transform between the two layouts. It is a copy of
``nylon_amt_tpu/train/importer.py::build_rules``, so that the port imports
nothing of the JAX package; ``tests/test_torch_train.py`` holds the two
tables equal. :func:`nylon_amt_tpu_torch.models.convert.params_from_jax`
walks it to carry flax parameters into the port.
"""

from __future__ import annotations

# torch Linear stores weight [out, in]; flax Dense kernel is [in, out].
_TRANSPOSE = "T"
_DIRECT = "="


def _layer_rules(prefix_t: str, prefix_f: tuple, has_self: bool, has_cross: bool):
    """Param mapping rules for one transformer layer."""
    rules = {}
    rules[f"{prefix_t}.layer_norm.weight"] = (prefix_f + ("layer_norm", "scale"), _DIRECT)
    rules[f"{prefix_t}.layer_norm.bias"] = (prefix_f + ("layer_norm", "bias"), _DIRECT)
    attn_blocks = []
    if has_self:
        attn_blocks.append("self_attention")
    if has_cross:
        attn_blocks.append("encoder_attention")
    for blk in attn_blocks:
        for fc in ("fc_q", "fc_k", "fc_v", "fc_o"):
            # MultiHeadAttention owns its projection params (flattened names)
            # so the Pallas path can project into head-blocked layout.
            rules[f"{prefix_t}.{blk}.{fc}.weight"] = (
                prefix_f + (blk, f"{fc}_kernel"), _TRANSPOSE)
            rules[f"{prefix_t}.{blk}.{fc}.bias"] = (
                prefix_f + (blk, f"{fc}_bias"), _DIRECT)
    for fc in ("fc_1", "fc_2"):
        rules[f"{prefix_t}.positionwise_feedforward.{fc}.weight"] = (
            prefix_f + ("positionwise_feedforward", fc, "kernel"), _TRANSPOSE)
        rules[f"{prefix_t}.positionwise_feedforward.{fc}.bias"] = (
            prefix_f + ("positionwise_feedforward", fc, "bias"), _DIRECT)
    return rules


def _head_rules(prefix_t: str, prefix_f: tuple, names: list[str]):
    rules = {}
    for n in names:
        rules[f"{prefix_t}.{n}.weight"] = (prefix_f + (n, "kernel"), _TRANSPOSE)
        rules[f"{prefix_t}.{n}.bias"] = (prefix_f + (n, "bias"), _DIRECT)
    return rules


def build_rules(enc_layers: int, dec_layers: int,
                enc_alg: str = "cnntime_safreq",
                dec_alg: str = "cafreq_satime",
                tab_head: bool = False) -> dict:
    """Full state_dict-key -> (flax path, transform) mapping.

    Covers the main model (``Model_SPEC2MIDI``) and the ablation grid
    (``model_spec2midi_ablation.py``); ablation models use the same
    ``encoder_spec2midi`` / ``decoder_spec2midi`` attribute names.
    ``tab_head`` adds ``decoder_spec2midi.fc_string_time`` (the JAX table
    has no such argument: its export drops the head).
    """
    r: dict[str, tuple] = {}
    e = "encoder_spec2midi"
    if enc_alg == "cnntime_safreq":
        r[f"{e}.conv.weight"] = (("encoder", "conv_kernel"), "conv")  # [C,1,1,k]->[C,k]
        r[f"{e}.conv.bias"] = (("encoder", "conv_bias"), _DIRECT)
        r[f"{e}.tok_embedding_freq.weight"] = (
            ("encoder", "tok_embedding_kernel"), _TRANSPOSE)
        r[f"{e}.tok_embedding_freq.bias"] = (
            ("encoder", "tok_embedding_bias"), _DIRECT)
    elif enc_alg == "cnnblock_safreq":
        # 4 conv blocks as nn.Sequential: indices 0/3 = Conv2d, 1/4 = BN.
        for b in range(1, 5):
            for seq_idx, conv_idx in ((0, 0), (3, 1)):
                r[f"{e}.conv_{b}.{seq_idx}.weight"] = (
                    ("encoder", f"conv_block_{b}", f"conv_{conv_idx}",
                     "kernel"), "conv2d")
                r[f"{e}.conv_{b}.{seq_idx}.bias"] = (
                    ("encoder", f"conv_block_{b}", f"conv_{conv_idx}",
                     "bias"), _DIRECT)
            for seq_idx, bn_idx in ((1, 0), (4, 1)):
                base = ("encoder", f"conv_block_{b}", f"bn_{bn_idx}")
                r[f"{e}.conv_{b}.{seq_idx}.weight"] = (base + ("scale",), _DIRECT)
                r[f"{e}.conv_{b}.{seq_idx}.bias"] = (base + ("bias",), _DIRECT)
                r[f"{e}.conv_{b}.{seq_idx}.running_mean"] = (
                    base + ("mean",), "batch_stat")
                r[f"{e}.conv_{b}.{seq_idx}.running_var"] = (
                    base + ("var",), "batch_stat")
                r[f"{e}.conv_{b}.{seq_idx}.num_batches_tracked"] = (None, "skip")
        r[f"{e}.tok_embedding_freq.weight"] = (
            ("encoder", "tok_embedding_freq", "kernel"), _TRANSPOSE)
        r[f"{e}.tok_embedding_freq.bias"] = (
            ("encoder", "tok_embedding_freq", "bias"), _DIRECT)
    else:
        raise ValueError(f"unknown enc_alg {enc_alg!r}")
    r[f"{e}.pos_embedding_freq.weight"] = (
        ("encoder", "pos_embedding_freq", "embedding"), _DIRECT)
    for i in range(enc_layers):
        r.update(_layer_rules(f"{e}.layers_freq.{i}",
                              ("encoder", f"layers_freq_{i}"),
                              has_self=True, has_cross=False))

    d = "decoder_spec2midi"
    freq_heads = ["fc_onset_freq", "fc_offset_freq", "fc_mpe_freq",
                  "fc_velocity_freq"]
    time_heads = ["fc_onset_time", "fc_offset_time", "fc_mpe_time",
                  "fc_velocity_time"]
    if dec_alg in ("cafreq_satime", "cafreq"):
        r[f"{d}.pos_embedding_freq.weight"] = (
            ("decoder", "pos_embedding_freq", "embedding"), _DIRECT)
        r.update(_layer_rules(f"{d}.layer_zero_freq",
                              ("decoder", "layer_zero_freq"),
                              has_self=False, has_cross=True))
        for i in range(dec_layers - 1):
            r.update(_layer_rules(f"{d}.layers_freq.{i}",
                                  ("decoder", f"layers_freq_{i}"),
                                  has_self=True, has_cross=True))
        r.update(_head_rules(d, ("decoder",), freq_heads))
    elif dec_alg == "linear_satime":
        r[f"{d}.fc_convert.weight"] = (("decoder", "fc_convert_kernel"),
                                       _TRANSPOSE)
        r[f"{d}.fc_convert.bias"] = (("decoder", "fc_convert_bias"), _DIRECT)
        r.update(_head_rules(d, ("decoder",), freq_heads))
    else:
        raise ValueError(f"unknown dec_alg {dec_alg!r}")
    if dec_alg in ("cafreq_satime", "linear_satime"):
        r[f"{d}.pos_embedding_time.weight"] = (
            ("decoder", "pos_embedding_time", "embedding"), _DIRECT)
        for i in range(dec_layers):
            r.update(_layer_rules(f"{d}.layers_time.{i}",
                                  ("decoder", f"layers_time_{i}"),
                                  has_self=True, has_cross=False))
        r.update(_head_rules(d, ("decoder",), time_heads))
    if tab_head:
        # the tablature head (ModelConfig.tab_head): no reference analog,
        # so the JAX table leaves it out; the port's modules carry it
        r.update(_head_rules(d, ("decoder",), ["fc_string_time"]))
    return r
