# SPDX-License-Identifier: Apache-2.0
"""Random Whisper weights drawn on the device from the run's seed.

Two draws of the whole model (one uniform, one normal) from a
``torch.Generator`` on the device, in the type the model is served in; each
leaf is then a scaled view of them. Matrices are uniform within
``1/sqrt(fan_in)``; every bias, layer-norm gain and shift is drawn too (a
zero bias would hide a bias that the program adds twice or never); token
embeddings are normal with 0.02, the decoder's positions normal with 1 (so
that the random decoder moves from token to token instead of repeating
one); the encoder's positions are the published sinusoids. The same
tensors go to the program and, read as float32, to the reference.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from reference.whisper import sinusoids


def dims(cfg: dict) -> dict:
    """A configuration file's sizes under the names the code uses."""
    return {
        "n_mels": cfg["num_mel_bins"], "n_vocab": cfg["vocab_size"], "d": cfg["d_model"],
        "enc_layers": cfg["encoder_layers"], "dec_layers": cfg["decoder_layers"],
        "enc_heads": cfg["encoder_attention_heads"], "dec_heads": cfg["decoder_attention_heads"],
        "enc_ffn": cfg["encoder_ffn_dim"], "dec_ffn": cfg["decoder_ffn_dim"],
        "n_audio_ctx": cfg["max_source_positions"], "n_text_ctx": cfg["max_target_positions"],
    }


def _specs(m: dict) -> Tuple[dict, List[tuple]]:
    """The leaf tree (leaves are indices into the returned spec list:
    ``(shape, kind, scale)``)."""
    specs: List[tuple] = []

    def leaf(shape, kind, scale=1.0):
        specs.append((tuple(shape), kind, scale))
        return len(specs) - 1

    def linear(d_in, d_out, bias=True):
        p = {"w": leaf((d_in, d_out), "uniform", d_in ** -0.5)}
        if bias:
            p["b"] = leaf((d_out,), "uniform", 0.02)
        return p

    def ln(d):
        return {"g": leaf((d,), "gain", 0.1), "b": leaf((d,), "uniform", 0.05)}

    def attn(d):
        return {"q": linear(d, d), "k": linear(d, d, bias=False), "v": linear(d, d), "o": linear(d, d)}

    d = m["d"]
    enc_layer = lambda: {"ln1": ln(d), "attn": attn(d), "ln2": ln(d), "mlp1": linear(d, m["enc_ffn"]),  # noqa: E731
                         "mlp2": linear(m["enc_ffn"], d)}
    dec_layer = lambda: {"ln1": ln(d), "attn": attn(d), "ln_x": ln(d), "xattn": attn(d), "ln2": ln(d),  # noqa: E731
                         "mlp1": linear(d, m["dec_ffn"]), "mlp2": linear(m["dec_ffn"], d)}
    tree = {
        "enc": {
            "conv1": {"w": leaf((3, m["n_mels"], d), "uniform", (3 * m["n_mels"]) ** -0.5),
                      "b": leaf((d,), "uniform", 0.02)},
            "conv2": {"w": leaf((3, d, d), "uniform", (3 * d) ** -0.5), "b": leaf((d,), "uniform", 0.02)},
            "pos": leaf((m["n_audio_ctx"], d), "sinusoid"),
            "layers": [enc_layer() for _ in range(m["enc_layers"])],
            "ln_post": ln(d),
        },
        "dec": {
            "tok_emb": leaf((m["n_vocab"], d), "normal", 0.02),
            # std 1, not the published init's 0.02: with 0.02 a random decoder repeats one
            # token with a 0.6-0.8 logit lead, and no rounding error flips any token
            "pos_emb": leaf((m["n_text_ctx"], d), "normal", 1.0),
            "layers": [dec_layer() for _ in range(m["dec_layers"])],
            "ln": ln(d),
        },
    }
    return tree, specs


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def draw(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weight tree of ``cfg`` (a configuration file's dict) from ``seed``."""
    m = dims(cfg)
    tree, specs = _specs(m)
    gen = torch.Generator(device=device).manual_seed(seed)
    n_uni = sum(_numel(s) for s, k, _ in specs if k in ("uniform", "gain"))
    n_norm = sum(_numel(s) for s, k, _ in specs if k == "normal")
    uni = torch.empty(n_uni, dtype=dtype, device=device).uniform_(-1.0, 1.0, generator=gen)
    norm = torch.empty(n_norm, dtype=dtype, device=device).normal_(0.0, 1.0, generator=gen)
    offsets = {"uniform": 0, "normal": 0}
    leaves = []
    for shape, kind, scale in specs:
        if kind == "sinusoid":
            leaves.append(sinusoids(*shape).to(device=device, dtype=dtype))
            continue
        buf, key = (norm, "normal") if kind == "normal" else (uni, "uniform")
        n = _numel(shape)
        t = buf[offsets[key] : offsets[key] + n].view(shape)
        offsets[key] += n
        t.mul_(scale)
        if kind == "gain":
            t.add_(1.0)
        leaves.append(t)

    def fill(x):
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, list):
            return [fill(v) for v in x]
        return leaves[x]

    return fill(tree)


def port_config(cfg: dict):
    """The program's ``WhisperConfig`` of a configuration file."""
    from streamkit_tpu_torch.models.whisper.config import WhisperConfig

    m = dims(cfg)
    if m["enc_ffn"] != 4 * m["d"] or m["dec_ffn"] != 4 * m["d"]:
        raise ValueError("the program's Whisper blocks have a feed-forward width of 4 d")
    return WhisperConfig(n_mels=m["n_mels"], n_audio_ctx=m["n_audio_ctx"], n_audio_state=m["d"],
                         n_audio_head=m["enc_heads"], n_audio_layer=m["enc_layers"], n_vocab=m["n_vocab"],
                         n_text_ctx=m["n_text_ctx"], n_text_state=m["d"], n_text_head=m["dec_heads"],
                         n_text_layer=m["dec_layers"])
