"""xLSTM language model: sLSTM + mLSTM blocks (counterpart of
``repro.models.xlstm``, arXiv:2405.04517).

Every ``slstm_every``-th block is sLSTM, the rest mLSTM. Every layer holds
both blocks' parameters, as the reference's stacked layers do, and runs one
of them; the other block's state passes through unchanged (the reference's
``lax.cond``). Layers are a Python list where the reference scans a stacked
axis; the decode state keeps the reference's stacked layout, {"mlstm": {C,
n, m, conv}, "slstm": {c, n2, m2, h}}, each leaf (L, ...). Attention-free:
there is no KV cache and no flash kernel on this path.

On a mesh whose "model" axis splits the parameters (``launch.train.run``
places them by the sharding rules), the embedding and the tied head with
its cross-entropy split the vocabulary, and each block splits or gathers
its leaves as ``ssm.py`` says (mLSTM: ``w_up``, ``wq``/``wk``/``wv``
gathered, ``gn``/``w_down`` split; sLSTM: ``w`` and ``r`` gathered). The
block a layer does not run keeps this rank's blocks with zero gradients
(``idle_params``). Serving runs on one device.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import base
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models import transformer as T


def _is_slstm(cfg: ModelConfig, idx: int) -> bool:
    return bool(cfg.slstm_every) and idx % cfg.slstm_every == cfg.slstm_every - 1


def specs(cfg: ModelConfig) -> dict:
    return {
        "embed": L.embedding_specs(cfg.vocab, cfg.d_model),
        "layers": [{"mlstm": ssm.mlstm_specs(cfg), "slstm": ssm.slstm_specs(cfg)}
                   for _ in range(cfg.n_layers)],
        "ln_f": T.norm_specs(cfg),
    }


def idle_params(cfg: ModelConfig) -> tuple[str, ...]:
    """The block each layer does not run, whose parameters the loss does not
    reach (``train_step.value_and_grad`` gives them zero gradients)."""
    return tuple(f"layers.{i}.{'mlstm' if _is_slstm(cfg, i) else 'slstm'}"
                 for i in range(cfg.n_layers))


def init_cache_specs(cfg: ModelConfig, batch: int, seq_len: int):
    del seq_len  # the state is O(1) in the sequence
    return {"mlstm": T.stack_specs(cfg.n_layers, ssm.mlstm_state_specs(cfg, batch)),
            "slstm": T.stack_specs(cfg.n_layers, ssm.slstm_state_specs(cfg, batch))}


def _run_layers(params, x, cfg: ModelConfig, cache=None):
    """Every layer over x from ``cache`` (zeros if None) -> (x, new cache)."""
    if cache is None:
        cache = base.tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=x.device),
                              init_cache_specs(cfg, x.shape[0], 0))
    new = {"mlstm": {k: [] for k in cache["mlstm"]}, "slstm": {k: [] for k in cache["slstm"]}}
    for i, lp in enumerate(params["layers"]):
        states = {blk: {k: v[i] for k, v in cache[blk].items()} for blk in new}
        blk = "slstm" if _is_slstm(cfg, i) else "mlstm"
        apply = ssm.slstm_apply if blk == "slstm" else ssm.mlstm_apply
        y, states[blk] = apply(lp[blk], x, cfg, states[blk])
        x = x + y
        for name, st in states.items():
            for k, v in st.items():
                new[name][k].append(v)
    return x, {blk: {k: torch.stack(v) for k, v in st.items()} for blk, st in new.items()}


def forward(params, batch, cfg: ModelConfig):
    x = L.embed(params["embed"], batch["tokens"], T.vocab_group(params, cfg)).to(cfg.dtype)
    x, _ = _run_layers(params, x, cfg)
    return T.norm(cfg, params["ln_f"], x)


def loss_fn(params, batch, cfg: ModelConfig):
    x = forward(params, batch, cfg)
    group = T.vocab_group(params, cfg)
    return L.softmax_xent(L.lm_logits(params["embed"], x, cfg.vocab, group), batch["labels"],
                          group=group)


def prefill(params, batch, cfg: ModelConfig):
    """batch: {"tokens": (B, S)} -> (last-position logits (B, 1, V), state)."""
    x = L.embed(params["embed"], batch["tokens"]).to(cfg.dtype)
    x, cache = _run_layers(params, x, cfg)
    x = T.norm(cfg, params["ln_f"], x)
    return L.lm_logits(params["embed"], x[:, -1:], cfg.vocab), cache


def decode_step(params, cache, tokens, pos, cfg: ModelConfig):
    """One step from the carried state; the state carries the position, so
    ``pos`` is unused."""
    del pos
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    x, cache = _run_layers(params, x, cfg, cache)
    x = T.norm(cfg, params["ln_f"], x)
    return L.lm_logits(params["embed"], x, cfg.vocab), cache
