"""Dense decoder LM as an ``nn.Module`` (mirrors ``repro/models/model.py``).

Depth is organised as head (unrolled) + core (stacked over periods) + tail
(unrolled), with the reference's split. Parameters are ``nn.Parameter``s
registered under the JAX tree's paths (``decoder.core.0.mixer.wq``,
``decoder.core.0.ln1.scale``, ``embed``, ``head``, ...); the core keeps its
leading ``[n_periods, ...]`` dimension, and a Python loop over periods takes
the place of ``lax.scan``.

Public API:
    LM(cfg, device=..., generator=...)
    .forward(batch, impl=, schedule=) -> (logits, aux, off)
    .loss(batch, impl=, schedule=)  -> (loss, {"ce", "aux"})
    .prefill(batch, capacity)       -> (cache, last_logits)
    .decode_step(cache, tokens)     -> (cache, logits)   # cache updated in place
    .init_cache(batch, capacity)    -> cache tree of meta tensors
    .materialize_cache(batch, capacity)
    .cast_weights()                 # matrices held in the compute dtype

The port runs ``("attn", "dense")`` layers (the deepseek-7b family,
gemma-7b, stablelm-1.6b, internvl2-76b), ``("ssm", "none")`` layers
(mamba2-2.7b: a Mamba-2 mixer, no MLP), ``("rec", "dense")`` layers (an
RG-LRU mixer), ``("local", "dense")`` sliding-window attention layers
(recurrentgemma-9b, gemma3-1b), the encoder-decoder's
bidirectional ``("enc", "dense")`` encoder layers and ``("xdec",
"dense")`` decoder layers (self-attention, then cross-attention over the
encoder output; seamless-m4t-large-v2), and the MoE families' ``("attn",
"moe")`` (deepseek-moe-16b) and ``("mla", "dense")``/``("mla", "moe")``
layers (deepseek-v2-236b: Multi-head Latent Attention). An MoE model's
first ``moe.first_k_dense`` layers are dense, of width
``moe.d_ff_dense``, and form the unrolled head of the stack; each MoE
layer adds its load-balance loss to ``aux``. Inputs are ``tokens``, plus
``frames`` for an encoder-decoder (run through the encoder) or
``vision_embeds`` for a vision model (put ahead of the token embeddings;
the loss skips them). ``cfg.remat`` ("none", "full", "dots_saveable") maps
to ``torch.utils.checkpoint`` per head and tail layer and per core period,
as the reference remats its layers and ``period_body``; it applies only
while grad is enabled. Sharding constraints have no counterpart on one
card.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils import checkpoint as _ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as REC
from repro_torch.models import ssm as SSM
from repro_torch.models.layers import (ParamDef, apply_mlp, apply_norm,
                                       flatten_paths, init_params, mlp_def,
                                       norm_def, tree_map)

_KINDS = (("attn", "dense"), ("local", "dense"), ("rec", "dense"),
          ("ssm", "none"), ("enc", "dense"), ("xdec", "dense"),
          ("attn", "moe"), ("mla", "dense"), ("mla", "moe"))
_MIXER_DEF = {"attn": A.attn_def, "local": A.attn_def, "enc": A.attn_def,
              "xdec": A.attn_def, "mla": A.mla_def, "rec": REC.rec_def,
              "ssm": SSM.ssm_def}


def _mlp_width(cfg: ModelConfig, mlpk: str) -> int:
    """A dense MLP's width: an MoE model's dense layers take
    ``moe.d_ff_dense`` (``cfg.d_ff`` is its experts' width)."""
    if cfg.moe is not None and mlpk == "dense":
        return cfg.moe.d_ff_dense or cfg.d_ff
    return cfg.d_ff


# ---------------------------------------------------------------------------
# Parameter trees as modules
# ---------------------------------------------------------------------------


class _Node(nn.Module):
    """A dict node of the parameter tree; ``node["key"]`` reads a child."""

    def __getitem__(self, key):
        return getattr(self, key)


def _to_module(tree):
    if isinstance(tree, list):
        return nn.ModuleList([_to_module(t) for t in tree])
    node = _Node()
    _fill(node, tree)
    return node


def _fill(module: nn.Module, tree: dict):
    for key, val in tree.items():
        if isinstance(val, torch.Tensor):
            module.register_parameter(key, nn.Parameter(val))
        else:
            module.add_module(key, _to_module(val))


def params_tree(module: nn.Module):
    """The module's parameters as the JAX-shaped tree of dicts and lists."""
    if isinstance(module, nn.ModuleList):
        return [params_tree(m) for m in module]
    d = dict(module._parameters)
    d.update({k: params_tree(m) for k, m in module._modules.items()})
    return d


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def layer_def(cfg: ModelConfig, kind: Tuple[str, str]):
    if kind not in _KINDS:
        raise ValueError(kind)
    mixer, mlpk = kind
    d = {"ln1": norm_def(cfg), "mixer": _MIXER_DEF[mixer](cfg)}
    if mixer == "xdec":
        d["ln_x"] = norm_def(cfg)
        d["cross"] = A.xattn_def(cfg)
    if mlpk == "moe":
        d["ln2"] = norm_def(cfg)
        d["mlp"] = MOE.moe_def(cfg)
    elif mlpk == "dense":
        d["ln2"] = norm_def(cfg)
        d["mlp"] = mlp_def(cfg, _mlp_width(cfg, mlpk))
    return d


def _self_kind(mixer):
    """The kind of a layer's self-attention: an ``xdec`` layer's is a
    causal ``"attn"`` one."""
    return "attn" if mixer == "xdec" else mixer


def _mlp_residual(cfg, mlpk, p, x):
    """x plus the layer's MLP (dense or MoE) -> (x, aux). The dense MLP
    takes its width from its weights."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if mlpk == "moe":
        y, aux = MOE.moe_apply(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
        x = x + y
    elif mlpk == "dense":
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["ln2"], x))
    return x, aux


def layer_prefill(cfg, kind, p, x, ctx, capacity=None):
    """Full-sequence layer -> (x, cache, aux). With ``capacity`` it also
    emits this layer's decode cache from the same pass: attention projects
    q/k/v once, cross-attention its encoder k/v once, SSM layers run the
    SSD once and RG-LRU layers the scan once (the reference computes each
    twice), MLA layers their compressed ``ckv``/``kpe`` rows once. An
    ``xdec`` layer reads the encoder output ``ctx["enc_out"]`` and adds its
    cross k/v to the cache as ``xk``/``xv``. ``aux`` is an MoE layer's
    load-balance loss, else 0."""
    mixer, mlpk = kind
    h = apply_norm(cfg, p["ln1"], x)
    cache = None
    if mixer in ("ssm", "rec"):
        prefill = SSM.ssm_prefill if mixer == "ssm" else REC.rec_prefill
        mx, c = prefill(cfg, p["mixer"], h, impl=ctx.get("impl"))
        if capacity is not None:
            cache = c
    elif mixer == "mla":
        mx, cache = A.mla_prefill(cfg, p["mixer"], h, ctx["positions"],
                                  capacity=capacity, impl=ctx.get("impl"))
    else:
        # the encoder's "enc" layers see every frame, with RoPE at the
        # frames' positions
        q, k, v = A._qkv(cfg, p["mixer"], h, ctx["positions"])
        if capacity is not None:
            cache = A.attn_prefill_cache(cfg, k, v, capacity,
                                         kind=_self_kind(mixer))
        mx = A.attn_core(cfg, p["mixer"], q, k, v, kind=_self_kind(mixer),
                         causal=mixer != "enc", impl=ctx.get("impl"))
    x = x + mx
    if mixer == "xdec":
        xk, xv = A.xattn_kv(cfg, p["cross"], ctx["enc_out"])
        if cache is not None:
            cache = dict(cache, xk=xk, xv=xv)
        x = x + A.xattn_forward(cfg, p["cross"],
                                apply_norm(cfg, p["ln_x"], x), xk, xv,
                                impl=ctx.get("impl"))
    x, aux = _mlp_residual(cfg, mlpk, p, x)
    return x, cache, aux


def layer_apply(cfg, kind, p, x, ctx):
    """Full-sequence layer. Returns (x, aux)."""
    x, _, aux = layer_prefill(cfg, kind, p, x, ctx)
    return x, aux


def layer_cache_def(cfg, kind, batch, capacity, dtype):
    mixer = kind[0]
    if mixer == "ssm":
        return SSM.ssm_cache_def(cfg, batch, dtype)
    if mixer == "rec":
        return REC.rec_cache_def(cfg, batch, dtype)
    if mixer == "mla":
        return A.mla_cache_def(cfg, batch, capacity, dtype)
    if mixer == "xdec":
        # cross k/v for cfg.frontend_tokens frames, as the reference's
        # LM.init_cache sizes them (a prefill's follow its frames)
        d = A.attn_cache_def(cfg, "attn", batch, capacity, dtype)
        shape = (batch, cfg.frontend_tokens, cfg.num_kv_heads, cfg.head_dim)
        return dict(d, xk=torch.empty(shape, dtype=dtype, device="meta"),
                    xv=torch.empty(shape, dtype=dtype, device="meta"))
    return A.attn_cache_def(cfg, mixer, batch, capacity, dtype)


def layer_decode(cfg, kind, p, x, cache, ctx):
    """One token; the cache's leaves are written in place."""
    mixer, mlpk = kind
    h = apply_norm(cfg, p["ln1"], x)
    if mixer == "ssm":
        mx, cache = SSM.ssm_decode(cfg, p["mixer"], h, cache)
    elif mixer == "rec":
        mx, cache = REC.rec_decode(cfg, p["mixer"], h, cache)
    elif mixer == "mla":
        mx, cache = A.mla_decode(cfg, p["mixer"], h, cache, ctx["positions"])
    else:
        mx, cache = A.attn_decode(cfg, p["mixer"], h, cache,
                                  ctx["positions"], kind=_self_kind(mixer))
    x = x + mx
    if mixer == "xdec":
        x = x + A.xattn_decode(cfg, p["cross"], apply_norm(cfg, p["ln_x"], x),
                               cache)
    x, _ = _mlp_residual(cfg, mlpk, p, x)
    return x, cache


# ---------------------------------------------------------------------------
# Depth segmentation + stacks
# ---------------------------------------------------------------------------


def periods(tree, n):
    """The ``n`` per-period trees of a stacked tree (leaves ``[n, ...]``),
    each leaf split by one ``unbind``. Under autograd its backward then
    writes a stacked gradient once; indexing period by period would add a
    zeroed full-size gradient per period, traffic quadratic in depth (the
    reference's ``lax.scan`` accumulates in place)."""
    if isinstance(tree, dict):
        parts = {k: periods(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, (list, tuple)):
        parts = [periods(v, n) for v in tree]
        return [[p[i] for p in parts] for i in range(n)]
    return list(tree.unbind(0))


# the matrix products whose outputs "dots_saveable" keeps (the reference's
# jax.checkpoint_policies.dots_saveable); everything else is recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(kind, fn):
    """``fn`` under the reference's remat policy ``kind``."""
    if kind == "none":
        return fn
    if kind == "full":
        return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False)
    if kind == "dots_saveable":
        return functools.partial(
            _ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                _ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(f"unknown remat {kind!r}")


class Stack(nn.Module):
    """head (unrolled) + core (stacked over periods) + tail (unrolled)."""

    def __init__(self, cfg: ModelConfig, kinds: Sequence[Tuple[str, str]],
                 period: int, head_n: int = 0):
        super().__init__()
        self.cfg = cfg
        self.kinds = list(kinds)
        L = len(kinds)
        if not cfg.scan_layers:
            head_n, period = 0, max(L, 1)
        self.head_kinds = self.kinds[:head_n]
        rest = L - head_n
        self.n_periods = rest // period if cfg.scan_layers else 0
        if self.n_periods <= 1:   # the reference does not scan one period
            self.n_periods = 0
        core_n = self.n_periods * period
        self.period_kinds = self.kinds[head_n:head_n + period] \
            if self.n_periods else []
        for i in range(core_n):
            assert self.kinds[head_n + i] == self.period_kinds[i % period]
        self.tail_kinds = self.kinds[head_n + core_n:]

    def defs(self):
        cfg = self.cfg

        def stacked(d: ParamDef) -> ParamDef:
            return ParamDef((self.n_periods,) + d.shape,
                            ("layers",) + d.axes, d.init, d.scale)

        return {
            "head": [layer_def(cfg, k) for k in self.head_kinds],
            "core": [tree_map(stacked, layer_def(cfg, k))
                     for k in self.period_kinds],
            "tail": [layer_def(cfg, k) for k in self.tail_kinds],
        }

    def cache_defs(self, batch, capacity, dtype):
        cfg = self.cfg

        def stacked(t):
            return torch.empty((self.n_periods,) + tuple(t.shape),
                               dtype=t.dtype, device="meta")

        return {
            "head": [layer_cache_def(cfg, k, batch, capacity, dtype)
                     for k in self.head_kinds],
            "core": [tree_map(stacked, layer_cache_def(cfg, k, batch,
                                                       capacity, dtype))
                     for k in self.period_kinds],
            "tail": [layer_cache_def(cfg, k, batch, capacity, dtype)
                     for k in self.tail_kinds],
        }

    def forward(self, x, ctx):
        """Full sequence (the reference's ``Stack.apply``) -> (x, aux).
        While grad is enabled each head and tail layer and each core period
        runs under ``cfg.remat``."""
        cfg, params = self.cfg, params_tree(self)
        kind = self.cfg.remat if torch.is_grad_enabled() else "none"
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def layers(pairs):
            def body(x):
                a = torch.zeros((), dtype=torch.float32, device=x.device)
                for k, p in pairs:
                    x, ak = layer_apply(cfg, k, p, x, ctx)
                    a = a + ak
                return x, a
            return _remat(kind, body)

        groups = [[pair] for pair in zip(self.head_kinds, params["head"])]
        groups += [list(zip(self.period_kinds, core))
                   for core in periods(params["core"], self.n_periods)]
        groups += [[pair] for pair in zip(self.tail_kinds, params["tail"])]
        for pairs in groups:
            x, a = layers(pairs)(x)
            aux = aux + a
        return x, aux

    def prefill(self, x, ctx, capacity):
        """Full sequence with decode caches -> (x, caches, aux)."""
        cfg, params = self.cfg, params_tree(self)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = {"head": [], "core": [], "tail": []}
        for k, p in zip(self.head_kinds, params["head"]):
            x, c, a = layer_prefill(cfg, k, p, x, ctx, capacity)
            caches["head"].append(c)
            aux = aux + a
        per_period = []
        for core in periods(params["core"], self.n_periods):
            cs = []
            for k, p in zip(self.period_kinds, core):
                x, c, a = layer_prefill(cfg, k, p, x, ctx, capacity)
                cs.append(c)
                aux = aux + a
            per_period.append(cs)
        if per_period and capacity is not None:
            caches["core"] = [
                {key: torch.stack([cs[j][key] for cs in per_period])
                 for key in per_period[0][j]}
                for j in range(len(self.period_kinds))]
        for k, p in zip(self.tail_kinds, params["tail"]):
            x, c, a = layer_prefill(cfg, k, p, x, ctx, capacity)
            caches["tail"].append(c)
            aux = aux + a
        return x, caches, aux

    def decode(self, x, cache, ctx):
        """One token for every row; cache leaves are updated in place."""
        cfg, params = self.cfg, params_tree(self)
        for k, p, c in zip(self.head_kinds, params["head"], cache["head"]):
            x, _ = layer_decode(cfg, k, p, x, c, ctx)
        for core, cores in zip(periods(params["core"], self.n_periods),
                               periods(cache["core"], self.n_periods)):
            for k, p, c in zip(self.period_kinds, core, cores):
                x, _ = layer_decode(cfg, k, p, x, c, ctx)
        for k, p, c in zip(self.tail_kinds, params["tail"], cache["tail"]):
            x, _ = layer_decode(cfg, k, p, x, c, ctx)
        return x, cache


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: torch.Generator = None):
        super().__init__()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("LM(device='cuda') but no CUDA device is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        self.cfg = cfg
        mixers = cfg.layer_kinds
        kinds = [(mixers[i], "none" if (cfg.d_ff == 0 and cfg.moe is None)
                  else cfg.mlp_kind_at(i)) for i in range(cfg.num_layers)]
        head_n = cfg.moe.first_k_dense if cfg.moe is not None else 0
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)
        if cfg.encoder_layers:
            kinds = [("xdec", k[1]) for k in kinds]
            self.encoder = Stack(cfg, [("enc", "dense")] * cfg.encoder_layers,
                                 period=1)
        else:
            self.encoder = None
        self.decoder = Stack(cfg, kinds, period=len(cfg.layer_pattern),
                             head_n=head_n)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        params = init_params(self.defs(), generator, self.param_dtype,
                             self.device)
        stacks = {name: params.pop(name) for name in ("decoder", "encoder")
                  if name in params}
        _fill(self, params)
        for name, tree in stacks.items():
            _fill(getattr(self, name), tree)

    # -- params -----------------------------------------------------------------
    def defs(self):
        cfg = self.cfg
        D, V = cfg.d_model, cfg.padded_vocab
        d = {
            "embed": ParamDef((V, D), ("vocab", "embed"), "fixed",
                              scale=0.02),
            "final_norm": norm_def(cfg),
            "decoder": self.decoder.defs(),
        }
        if not cfg.tie_embeddings:
            d["head"] = ParamDef((D, V), ("embed", "vocab"))
        if self.encoder is not None:
            d["encoder"] = self.encoder.defs()
            d["enc_norm"] = norm_def(cfg)
        return d

    @torch.no_grad()
    def cast_weights(self):
        """Hold every weight matrix in the compute dtype instead of the param
        dtype. The reference casts each matrix to the compute dtype at every
        use, so the numbers do not change. One-dimensional parameters (per
        layer, the stacked ``layers`` axis aside: norm scales, Mamba's
        ``dt_bias``, ``A_log`` and ``D``, RG-LRU's ``a_log``), which it reads
        in fp32, stay as they are. RG-LRU's gate biases ``b_ga``/``b_gx``
        stay too; the reference casts them at each use, as the port does.
        So does an MoE layer's ``router``, which the reference reads in
        fp32. Halves the bytes of an fp32-param model held in bf16."""
        defs = dict(flatten_paths(self.defs()))
        for name, p in self.named_parameters():
            if sum(a != "layers" for a in defs[name].axes) >= 2 and \
                    not name.endswith(".router"):
                p.data = p.data.to(self.compute_dtype)
        return self

    # -- embedding / logits -------------------------------------------------------
    def _embed(self, tokens):
        # F.embedding sums each row's gradients in a fixed order; the
        # backward of self.embed[tokens] adds them by atomics on a
        # multi-threaded CPU, and a restarted run could then not be held to
        # the uninterrupted one bit for bit
        x = F.embedding(tokens.long(), self.embed).to(self.compute_dtype)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5,
                                 dtype=self.compute_dtype)
        return x

    def _logits(self, x):
        cfg = self.cfg
        x = apply_norm(cfg, params_tree(self.final_norm), x)
        w = self.embed.T if cfg.tie_embeddings else self.head
        logits = x @ w.to(self.compute_dtype)
        if cfg.logits_softcap > 0:
            logits = torch.tanh(logits / cfg.logits_softcap) * \
                cfg.logits_softcap
        return logits

    def _positions(self, B, S):
        return torch.arange(S, device=self.device)[None].expand(B, S)

    def _inputs(self, batch, impl=None):
        """-> (x, enc_out, loss offset). An encoder-decoder runs its
        ``frames`` [B,Se,D] through the encoder and ``enc_norm``; a vision
        model puts its ``vision_embeds`` [B,Nv,D] ahead of the token
        embeddings, and the loss starts after them. The reference's
        encoder gets a ctx without ``impl`` (its default implementation);
        the port's takes the caller's, so on the card the flash kernel runs
        the encoder too, and ``impl="plain"`` holds all of it plain."""
        cfg = self.cfg
        if cfg.encoder_layers:
            enc = batch["frames"].to(self.compute_dtype)
            B, Se, _ = enc.shape
            enc, _ = self.encoder(enc, {"positions": self._positions(B, Se),
                                        "impl": impl})
            enc = apply_norm(cfg, params_tree(self.enc_norm), enc)
            return self._embed(batch["tokens"]), enc, 0
        if cfg.frontend == "vision":
            ve = batch["vision_embeds"].to(self.compute_dtype)
            return (torch.cat([ve, self._embed(batch["tokens"])], 1), None,
                    ve.shape[1])
        return self._embed(batch["tokens"]), None, 0

    # -- full-sequence forward ------------------------------------------------------
    def forward(self, batch, *, impl=None, schedule="full"):
        """batch["tokens"]: [B,S] (with ``frames`` or ``vision_embeds`` as
        the config asks) -> (logits [B,S',V], aux, loss offset), S' = Nv + S
        for a vision model. ``schedule`` is the reference's attention
        schedule: "full" and "triangular" give the same numbers here, since
        the kernels and the plain version already skip the blocks the mask
        rules out."""
        if schedule not in ("full", "triangular"):
            raise ValueError(f"unknown attention schedule {schedule!r}")
        x, enc_out, off = self._inputs(batch, impl)
        B, S, _ = x.shape
        ctx = {"positions": self._positions(B, S), "enc_out": enc_out,
               "impl": impl}
        x, aux = self.decoder(x, ctx)
        return self._logits(x), aux, off

    def loss(self, batch, *, impl=None, schedule="full"):
        """Next-token cross-entropy in fp32 over the text region and the
        padded vocab, plus ``aux`` (the reference's ``LM.loss``).
        Returns (loss, {"ce", "aux"})."""
        logits, aux, off = self.forward(batch, impl=impl, schedule=schedule)
        S = logits.shape[1]
        lf = logits[:, off:S - 1].float()
        labels = batch["tokens"][:, 1:].long()
        gold = torch.gather(lf, -1, labels[..., None])[..., 0]
        ce = torch.mean(torch.logsumexp(lf, -1) - gold)
        return ce + aux, {"ce": ce, "aux": aux}

    # -- serving ---------------------------------------------------------------------
    def init_cache(self, batch, capacity):
        return {"lengths": torch.empty((batch,), dtype=torch.int32,
                                       device="meta"),
                "layers": self.decoder.cache_defs(batch, capacity,
                                                  self.compute_dtype)}

    def materialize_cache(self, batch, capacity):
        return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                              device=self.device),
                        self.init_cache(batch, capacity))

    @torch.no_grad()
    def prefill(self, batch, capacity, *, impl=None):
        """-> (cache, last logits [B,V]); the cache's ``lengths`` count the
        vision embeds too, and an encoder-decoder's ``xdec`` layers hold the
        cross k/v of the batch's frames as ``xk``/``xv``."""
        x, enc_out, _ = self._inputs(batch, impl)
        B, S, _ = x.shape
        ctx = {"positions": self._positions(B, S), "enc_out": enc_out,
               "impl": impl}
        x, layer_cache, _ = self.decoder.prefill(x, ctx, capacity)
        cache = {"lengths": torch.full((B,), S, dtype=torch.int32,
                                       device=self.device),
                 "layers": layer_cache}
        return cache, self._logits(x[:, -1:])[:, 0]

    @torch.no_grad()
    def decode_step(self, cache, tokens):
        """tokens: [B,1] -> (cache, logits [B,V]). The cache's layer leaves
        (k/v rows, SSM conv window and state) are written in place;
        ``lengths`` is a new tensor."""
        x = self._embed(tokens)
        ctx = {"positions": cache["lengths"]}
        x, layers = self.decoder.decode(x, cache["layers"], ctx)
        new = {"lengths": cache["lengths"] + 1, "layers": layers}
        return new, self._logits(x)[:, 0]
