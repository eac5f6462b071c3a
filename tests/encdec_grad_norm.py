"""The gradient of seamless-m4t-large-v2's loss on one batch, by the port
in float32 against a float64 copy of the port on the same weights and
batch, and (on the CPU) by the JAX reference in float32 beside them.
Prints one JSON line per configuration: each side's loss, the global
gradient norm and the norms of the encoder's, the decoder's and the
embedding table's gradients, and each float32 gradient's relative L2
distance to the float64 one.

    # CPU: JAX's init and the reference pipeline's batch (frames are
    # normal draws times 0.02), bridged into the port
    PYTHONPATH=src python tests/encdec_grad_norm.py --layers 24 \\
        --d-model 64 --d-ff 128 --heads 4 --seq 32
    # the card: chip_smoke.py's train-encdec weights and batch (no JAX)
    python tests/encdec_grad_norm.py --device cuda --layers 24 --seq 2048

``--layers`` sets both stacks; widths default to the full config's
(d_model 1024, d_ff 8192, 16 heads of 64, vocab 256206), so every cut is
named on the command line. On the CPU a full-width step holds some 5.5 GB
of float32 weights a side at 24 + 24 layers: run narrow widths at full
depth there, and the full width at a cut depth. Every side runs the plain
path (``impl="plain"``).
"""
import argparse
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

ARCH = "seamless-m4t-large-v2"
F64 = "repro_torch_f64"


def float64_port(dst):
    """A copy of the port, as the package ``repro_torch_f64``, whose fp32
    casts and dtype names are float64 ones, so that its plain path computes
    in float64 (as ``tests/test_torch_ckpt.py``'s witness)."""
    import repro_torch
    out = os.path.join(dst, F64)
    shutil.copytree(os.path.dirname(repro_torch.__file__), out,
                    ignore=shutil.ignore_patterns("__pycache__"))
    for base, _, files in os.walk(out):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            with open(path) as fh:
                text = fh.read()
            for a, b in (("torch.float32", "torch.float64"),
                         (".float()", ".double()"),
                         ('"float32"', '"float64"'),
                         ("repro_torch", F64)):
                text = text.replace(a, b)
            with open(path, "w") as fh:
                fh.write(text)
    sys.path.insert(0, dst)
    return F64


def _group(path):
    head = path.split(".")[0]
    return ("encoder" if head.startswith("enc") else
            "decoder" if head == "decoder" else
            "embed" if head == "embed" else "other")


def _norms(grads):
    """{group: norm, "total": norm} of {dotted path: float64 array}."""
    sq = {"encoder": 0.0, "decoder": 0.0, "embed": 0.0, "other": 0.0}
    for path, g in grads.items():
        sq[_group(path)] += float(np.sum(g * g))
    out = {k: float(np.sqrt(v)) for k, v in sq.items()}
    out["total"] = float(np.sqrt(sum(sq.values())))
    return out


def _rel(grads, want):
    """Relative L2 distance of ``grads`` to ``want``, over all leaves."""
    num = sum(float(np.sum((grads[n] - w) ** 2)) for n, w in want.items())
    den = sum(float(np.sum(w * w)) for w in want.values())
    return float(np.sqrt(num / den))


def overrides(layers, d_model=None, d_ff=None, heads=None, vocab=None):
    """The config fields a cut changes (the same on every side)."""
    o = {"num_layers": layers, "encoder_layers": layers, "dtype": "float32"}
    if d_model is not None:
        o["d_model"] = d_model
    if d_ff is not None:
        o["d_ff"] = d_ff
    if heads is not None:
        o.update(num_heads=heads, num_kv_heads=heads)
    if vocab is not None:
        o["vocab_size"] = vocab
    return o


def _port_grads(pkg, cfg, weights, batch, device):
    """(loss, {path: float64 grad}) of package ``pkg``'s LM at
    ``weights``."""
    import torch
    lm = importlib.import_module(pkg + ".models.model").LM(cfg,
                                                           device=device)
    with torch.no_grad():
        for n, p in lm.named_parameters():
            p.copy_(weights[n])
    loss = lm.loss({k: v.to(device) for k, v in batch.items()},
                   impl="plain")[0]
    loss.backward()
    grads = {n: p.grad.double().cpu().numpy()
             for n, p in lm.named_parameters()}
    return float(loss.detach()), grads


def _sides(cfg, weights, batch, device, f64, extra=None):
    """The port's float32 and the float64 copy's gradients, and
    ``extra``'s (name, loss, grads) beside them."""
    sides = dict([("port_f32", _port_grads("repro_torch", cfg, weights,
                                           batch, device))] + (extra or []))
    base64 = importlib.import_module(f64 + ".configs.base")
    cfg64 = base64.ModelConfig(**{k: getattr(cfg, k)
                                  for k in cfg.__dataclass_fields__})
    w64 = {n: w.double() for n, w in weights.items()}
    loss64, g64 = _port_grads(f64, cfg64.replace(dtype="float64"), w64,
                              batch, device)
    out = {"port_f64": {"loss": loss64, "norms": _norms(g64)}}
    for name, (loss, grads) in sides.items():
        out[name] = {"loss": loss, "norms": _norms(grads),
                     "rel_l2_to_f64": _rel(grads, g64)}
    return out


def cpu_run(over, seq, seed, f64):
    """JAX's init and batch, JAX's float32 gradient, the port's two."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs.base import get_config as jax_config
    from repro.models.model import LM as JaxLM
    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import flatten_paths

    jcfg = dataclasses.replace(jax_config(ARCH), **over)
    cfg = get_config(ARCH).replace(**over)
    jlm = JaxLM(jcfg)
    params = jax.tree.map(np.asarray, jlm.init(jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed + 1)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (1, seq))
             .astype(np.int32),
             "frames": (rng.randn(1, seq, cfg.d_model) * 0.02)
             .astype(np.float32)}

    def loss_fn(p):
        return jlm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()})[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    jgrads = {n: np.asarray(g, np.float64)
              for n, g in flatten_paths(jax.tree.map(np.asarray, jgrads))}
    weights = {n: torch.from_numpy(np.array(a))
               for n, a in flatten_paths(params)}
    del params
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    return _sides(cfg, weights, tbatch, "cpu", f64,
                  [("jax_f32", (float(jloss), jgrads))])


def card_run(over, seq, f64):
    """chip_smoke.py's train-encdec weights (the port's init, seed 0) and
    train batch at ``seq`` positions, on the card."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import LM
    cfg = get_config(ARCH).replace(**over)
    lm = LM(cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
    weights = {n: p.detach().clone() for n, p in lm.named_parameters()}
    del lm
    chip_smoke.TRAIN_S = seq
    batch = chip_smoke._train_batch(cfg, 1)
    return _sides(cfg, weights, batch, "cuda", f64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, nargs="+", required=True,
                    help="encoder and decoder layers, one run each")
    ap.add_argument("--d-model", type=int)
    ap.add_argument("--d-ff", type=int)
    ap.add_argument("--heads", type=int)
    ap.add_argument("--vocab", type=int)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    a = ap.parse_args(argv)
    if a.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        f64 = float64_port(tmp)
        for layers in a.layers:
            over = overrides(layers, a.d_model, a.d_ff, a.heads, a.vocab)
            r = (cpu_run(over, a.seq, a.seed, f64) if a.device == "cpu"
                 else card_run(over, a.seq, f64))
            print(json.dumps({"overrides": over, "seq": a.seq,
                              "device": a.device, **r}), flush=True)


if __name__ == "__main__":
    main()
