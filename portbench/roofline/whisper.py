# SPDX-License-Identifier: Apache-2.0
"""Model operations of Whisper's steps, counted as the plain model needs
them (two operations a multiply-add, matrix products and attention only)."""


def encoder_position(d: int, ffn: int, keys: int) -> int:
    """One encoder layer at one position attending to ``keys`` positions."""
    return 2 * 4 * d * d + 2 * 2 * d * ffn + 4 * d * keys


def decoder_token(d: int, ffn: int, self_keys: int, cross_keys: int) -> int:
    """One decoder layer for one token: self q, k, v, o; cross q, o; the
    feed-forward; both attentions."""
    return 2 * 6 * d * d + 2 * 2 * d * ffn + 4 * d * (self_keys + cross_keys)


def cross_kv(d: int, positions: int, layers: int) -> int:
    """The decoder's cross keys and values of ``positions`` encoder states."""
    return 2 * 2 * d * d * positions * layers


def conv_frontend(n_mels: int, d: int, mel_out: int, positions: int) -> int:
    """conv1 (k = 3, n_mels → d) at ``mel_out`` frames, conv2 (k = 3, d → d)
    at ``positions``."""
    return 2 * 3 * n_mels * d * mel_out + 2 * 3 * d * d * positions


def logits(d: int, vocab: int) -> int:
    return 2 * d * vocab


def stream_call(m: dict, rows) -> int:
    """The useful work of one fused live call: per row ``(pos, committed,
    fed)``: its committed chunk positions encoded against the history below
    ``pos`` (block-causal within the chunk) with their cross keys and values,
    and one decoder token per position ``fed`` (each fed at its column)."""
    d = m["d"]
    total = 0
    for pos, committed, fed in rows:
        for j in range(int(committed)):
            keys = int(pos) + (j // 8 + 1) * 8
            total += m["enc_layers"] * encoder_position(d, m["enc_ffn"], keys)
        if committed:
            total += conv_frontend(m["n_mels"], d, 2 * int(committed) + 3, int(committed))
            total += cross_kv(d, int(committed), m["dec_layers"])
        for col, horizon in fed:
            total += m["dec_layers"] * decoder_token(d, m["dec_ffn"], int(col) + 1, int(horizon))
            total += logits(d, m["n_vocab"])
    return total
