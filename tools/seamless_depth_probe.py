#!/usr/bin/env python3
"""Where seamless-m4t-large-v2's kernel-vs-plain readings lose their digits.

    python3 tools/seamless_depth_probe.py     # one CUDA card, about 100 s

Builds the kernels, then seamless-m4t-large-v2 at full width and depth
(24 encoder + 24 decoder layers, seeded random weights) in bf16 and as an
fp32 twin, and runs ``chip_smoke.py``'s request 0 (16 tokens over 4096
seeded frames) through the flash kernel, the plain attention, the plain
code in 64-wide chunks (a witness), SDPA (a second witness, bf16) and the
mask-fault control. It prints, per code, the relative L2 error against the
plain code of the encoder's hidden state after 1, 2, 4, 8, 12, 16 and 24
layers (with the stream's rms and its spread across frames), of the
decoder's after 1, 2, 4, 8 and 24 layers and its last-logits over one
encoder output (the plain code's, given to every code), and of the whole
path: after the encoder and 4 decoder layers, and the last-logits. These
readings place ``chip_smoke.py``'s ``logits-seamless`` gates.
"""
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

ENC_DEPTHS = (1, 2, 4, 8, 12, 16, 24)
DEC_DEPTHS = (1, 2, 4, 8, 24)


def _layers(stack):
    from repro_torch.models.model import params_tree, periods
    p = params_tree(stack)
    out = list(zip(stack.head_kinds, p["head"]))
    for core in periods(p["core"], stack.n_periods):
        out += list(zip(stack.period_kinds, core))
    return out + list(zip(stack.tail_kinds, p["tail"]))


def _walk(lm, x, ctx, stack, depths):
    """Hidden states after each of ``depths`` layers of ``stack``, and the
    stream after all of them."""
    from repro_torch.models.model import layer_prefill
    out = {}
    for i, (k, p) in enumerate(_layers(stack)):
        x, _, _ = layer_prefill(lm.cfg, k, p, x, ctx)
        if i + 1 in depths:
            out[i + 1] = x.clone()
    return out, x


def _readings(lm, batch, impl, enc_shared):
    import torch
    from repro_torch.models.layers import apply_norm
    from repro_torch.models.model import params_tree
    with torch.no_grad():
        fr = batch["frames"].to(lm.compute_dtype)
        ctx = {"positions": lm._positions(*fr.shape[:2]), "impl": impl}
        enc_h, x = _walk(lm, fr, ctx, lm.encoder, ENC_DEPTHS)
        enc = apply_norm(lm.cfg, params_tree(lm.enc_norm), x)
        tok = lm._embed(batch["tokens"])
        out = {f"enc{d}": h for d, h in enc_h.items()}
        for label, e in (("shared_enc", enc_shared), ("full", enc)):
            if e is None:
                continue
            ctx = {"positions": lm._positions(*tok.shape[:2]),
                   "enc_out": e, "impl": impl}
            dec_h, y = _walk(lm, tok, ctx, lm.decoder, DEC_DEPTHS)
            keep = DEC_DEPTHS if label == "shared_enc" else (4,)
            out.update({f"dec{d}_{label}": dec_h[d] for d in keep})
            out[f"logits_{label}"] = lm._logits(y[:, -1:])[:, 0]
    return out, enc


def probe(lm, batch):
    import torch
    codes = {"kernel": (None, None), "plain": ("plain", None),
             "witness": ("plain", cs._plain_small_chunks),
             "control": ("plain", cs._plain_mask_fault)}
    if lm.compute_dtype == torch.bfloat16:
        codes["sdpa"] = ("plain", cs._sdpa_witness)
    _, enc_plain = _readings(lm, batch, "plain", None)
    runs = {}
    for name, (impl, fn) in codes.items():
        if fn is None:
            runs[name] = _readings(lm, batch, impl, enc_plain)[0]
        else:
            with cs.plain_attention_as(fn):
                runs[name] = _readings(lm, batch, impl, enc_plain)[0]
    ref = runs.pop("plain")
    out = {}
    for key, p in ref.items():
        out[key] = {n: cs._rel(r[key], p) for n, r in runs.items()}
        if key.startswith("enc"):
            pf = p.float()
            out[key]["rms"] = pf.pow(2).mean().sqrt().item()
            out[key]["spread_across_frames"] = (
                (pf - pf.mean(1, keepdim=True)).norm() / pf.norm()).item()
    return out


def main():
    import torch
    from repro_torch.models.model import LM
    if not torch.cuda.is_available():
        print("seamless_depth_probe: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"card: {torch.cuda.get_device_name(0)}; {cs.nvidia_smi()}")
    cs.phase_build()
    lm = cs.build_lm("seamless-m4t-large-v2")
    batch = cs.request_batch(lm.cfg, cs.make_prompts(lm.cfg)[0], 0)
    cs.log("bf16 " + json.dumps(probe(lm, batch)))
    cfg = lm.cfg
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    lm32 = LM(cfg.replace(dtype="float32"), device=cs.DEVICE,
              generator=torch.Generator(device=cs.DEVICE).manual_seed(0))
    cs.log("fp32 " + json.dumps(probe(lm32, batch)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
