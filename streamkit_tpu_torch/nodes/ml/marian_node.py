# SPDX-License-Identifier: Apache-2.0
"""Helsinki opus-mt translation node (``plugin::native::helsinki``).

Port of ``streamkit_tpu/nodes/ml/marian_node.py``. Parity target:
``plugins/native/helsinki/`` — Marian checkpoints with SentencePiece
vocabularies, one language pair per model. Distinct from the NLLB node:
Marian architecture (:mod:`streamkit_tpu_torch.models.marian`), a unigram
SentencePiece tokenizer (:mod:`streamkit_tpu_torch.models.sp_tokenizer`), and
no language tokens (the pair is baked into the checkpoint).
"""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional

import numpy as np
import torch

from ...core import (
    ChannelClosed,
    ConfigurationError,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    ProcessorNode,
    ResourceKey,
    TelemetryEmitter,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason
from ...device import resolve_device
from ...models.marian import (
    MarianConfig,
    marian_beam_translate,
    marian_config_from_hf,
    marian_greedy_cached,
    marian_init_params,
    marian_params_from_hf,
)
from ._text_batching import BucketedGreedy

__all__ = ["MarianTranslateNode", "RANDOM_INIT_CONFIG"]

# the model of a node without a checkpoint: the reference node's own tiny
# configuration, drawn from seed 0 (mechanics-only mode)
RANDOM_INIT_CONFIG = MarianConfig(
    vocab_size=260, d_model=64, encoder_layers=2, decoder_layers=2,
    heads=4, ffn_dim=128, max_positions=256,
    pad_token_id=259, eos_token_id=0, decoder_start_token_id=259,
)


class _ByteTok:
    """Offline mechanics fallback (no checkpoint): utf-8 bytes as ids."""

    def __init__(self, cfg: MarianConfig) -> None:
        self.cfg = cfg

    def encode(self, text: str) -> List[int]:
        return [b % (self.cfg.vocab_size - 2) + 1 for b in text.encode()][:120] + [
            self.cfg.eos_token_id
        ]

    def decode_ids(self, ids) -> str:
        return bytes(
            max(1, (int(i) - 1) % 256) for i in ids if int(i) not in
            (self.cfg.eos_token_id, self.cfg.pad_token_id, self.cfg.decoder_start_token_id)
        ).decode("utf-8", "replace")


class MarianTranslateNode(ProcessorNode):
    """Text/Transcription → translated Text via Marian (helsinki role)."""

    KIND = "plugin::native::helsinki"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "model_path": None,  # HF MarianMTModel dir, or dir w/ *.spm
                "model_dir": None,  # reference param name (helsinki config)
                "source_language": None,  # informational: pair is baked into the model
                "target_language": None,
                "max_tokens": 128,
                "max_length": None,  # reference alias for max_tokens
                "beam_size": 1,  # 1 = greedy; >1 = beam search (models/seq2seq.py)
                "allow_random_init": True,
                "device": None,  # accepted for reference-yaml compat
                "num_threads": None,
                "compute_type": None,
                "dtype": "float32",
            },
        )
        self.device = resolve_device(device)
        self.model_path = cfg["model_path"] or cfg["model_dir"]
        self.source_language = cfg["source_language"]
        self.target_language = cfg["target_language"]
        self.max_tokens = int(cfg["max_length"] or cfg["max_tokens"])
        self.beam_size = int(cfg["beam_size"])
        if not 1 <= self.beam_size <= 8:
            raise ConfigurationError(
                "plugin::native::helsinki: beam_size must be 1-8"
            )
        self.allow_random_init = bool(cfg["allow_random_init"])
        self.dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.text(), PacketType.transcription()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.text())]

    async def _load(self, ctx: NodeContext):
        async def loader():
            loop = asyncio.get_running_loop()

            def build():
                if self.model_path and os.path.isdir(self.model_path):
                    import transformers

                    hf_cfg = transformers.AutoConfig.from_pretrained(self.model_path)
                    model = transformers.MarianMTModel.from_pretrained(self.model_path)
                    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
                    cfg = marian_config_from_hf(hf_cfg)
                    params = marian_params_from_hf(sd, cfg, self.dtype, self.device)
                    spm_src = os.path.join(self.model_path, "source.spm")
                    if os.path.exists(spm_src):
                        from ...models.sp_tokenizer import SentencePieceModel

                        sp_s = SentencePieceModel.load(spm_src)
                        tgt = os.path.join(self.model_path, "target.spm")
                        sp_t = SentencePieceModel.load(tgt) if os.path.exists(tgt) else sp_s

                        class _SpTok:
                            def encode(self, text):
                                return sp_s.encode(text)

                            def decode_ids(self, ids):
                                return sp_t.decode(
                                    [int(i) for i in ids
                                     if int(i) not in (cfg.eos_token_id, cfg.pad_token_id,
                                                       cfg.decoder_start_token_id)]
                                )

                        return cfg, params, _SpTok()
                    tok = transformers.AutoTokenizer.from_pretrained(self.model_path)

                    class _HFTok:
                        def encode(self, text):
                            return tok(text).input_ids

                        def decode_ids(self, ids):
                            return tok.decode([int(i) for i in ids], skip_special_tokens=True)

                    return cfg, params, _HFTok()
                if not self.allow_random_init:
                    raise ConfigurationError(f"marian model not found: {self.model_path}")
                cfg = RANDOM_INIT_CONFIG
                return cfg, marian_init_params(cfg, 0, self.dtype, self.device), _ByteTok(cfg)

            return await loop.run_in_executor(None, build)

        key = ResourceKey.from_params(
            "marian", {"path": self.model_path, "dtype": str(self.dtype), "device": str(self.device)}
        )
        if ctx.resources is not None:
            return await ctx.resources.get_or_create(key, loader)
        return await loader()

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx)
        cfg, params, tok = await self._load(ctx)
        ctx.emit_state(NodeState.running())
        loop = asyncio.get_running_loop()

        # cached greedy (or beam) decode on pow-2 source buckets; the engine
        # batcher coalesces texts across sessions (nodes/ml/_text_batching.py)
        max_tok = self.max_tokens
        pad_id = cfg.pad_token_id
        beam = self.beam_size
        if beam > 1:
            decode = lambda src_b: marian_beam_translate(  # noqa: E731
                params, cfg, src_b, max_tokens=max_tok, beam=beam
            )
        else:
            decode = lambda src_b: marian_greedy_cached(  # noqa: E731
                params, cfg, src_b, max_tokens=max_tok
            )
        bg = BucketedGreedy(
            f"marian:{id(params)}:{max_tok}:b{beam}", cfg.max_positions, pad_id, decode, device=self.device
        )

        def _strip(toks: np.ndarray, n: int) -> str:
            return tok.decode_ids(
                [i for i in toks[:n] if i not in (cfg.eos_token_id, pad_id)]
            )

        def translate_sync(text: str) -> str:
            return _strip(*bg.run_single(tok.encode(text)))

        async def translate_batched(text: str) -> str:
            return _strip(*(await bg.run_batched(ctx.batcher, tok.encode(text))))

        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                text = pkt.text if pkt.text is not None else (
                    pkt.transcription.text if pkt.transcription else None
                )
                if not text:
                    stats.packet_discarded()
                    continue
                if ctx.batcher is not None:
                    translated = await translate_batched(text)
                else:
                    translated = await loop.run_in_executor(None, translate_sync, text)
                telemetry.emit(
                    "translate.result", {"source": text[:120], "target": translated[:120]}
                )
                await ctx.output.send("out", Packet.new_text(translated, pkt.metadata))
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
