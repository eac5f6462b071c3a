"""The JAX side of the port's multi-device tests, run in a subprocess that
sees 8 host devices (``XLA_FLAGS=--xla_force_host_platform_device_count=8``;
the tier-1 process sees one). Each job reads its inputs from ``in.npz`` in
a directory and writes numpy results there.

    python tests/jax_mesh_ref.py <job> <dir>

Jobs: ``indices`` (``NamedSharding.devices_indices_map`` of the cases in
``cases.json``), ``ep`` (``moe_apply`` on the local path and on meshes
(1,2), (1,4) and (2,2), with gradients, at capacity factor 8 and, on the
meshes, at each of the input's ``low_cfs``, where copies drop; two AdamW
steps of the deepseek-moe-16b smoke LM on the (2,2) mesh, with ``m`` after
the first), ``specs`` (``launch.specs.input_specs`` of the cells in
``cases.json``: each argument leaf's shape, dtype and resolved spec) and
``flops`` (per-device FLOPs of each cell in ``cases.json``, smoke configs,
by ``roofline.hlo.analyze_text`` of the compiled step, as the dry-run) and
``tp`` (GSPMD on the cases of ``cases.json``, [model, arch, config
overrides (a ``moe`` entry a dict of ``MoEConfig`` fields), mesh
shape, key]: the weights ``<model>.<path>`` placed at their
specs, the batch at its spec (an encoder-decoder's ``frames`` beside the
tokens); the logits and one AdamW step, whose ``m``
is (1 - b1) times each leaf's clipped gradient, in one jitted call per
case, written under the case's key) and ``serve`` (GSPMD serving cells
of the cases of ``cases.json``, [key, arch, config overrides, mesh
shape, global batch, capacity]: ``launch.specs``' prefill of the tokens
``<key>.tokens`` (and an encoder-decoder's ``<key>.frames``, as many as
the capacity) and three decode steps of ``<key>.dec``, each at the
cell's in and out shardings; the logits of each call, the cache after
the prefill and after the last step, and each cache leaf's
``devices_indices_map`` in the mesh's device order, in ``indices.json``).
"""
import json
import os
import sys

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

EP_MESHES = ((1, 2), (1, 4), (2, 2))


def _mesh(shape, axes):
    import jax
    from jax.sharding import AxisType, Mesh
    n = int(np.prod(shape))
    devs = np.array(jax.devices()[:n]).reshape(shape)
    return Mesh(devs, tuple(axes), axis_types=(AxisType.Auto,) * len(axes))


def _dotted(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _tree_from(flat, like):
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map_with_path(
        lambda kp, x: jnp.asarray(flat[_dotted(kp)], x.dtype), like)


def _flat(tree):
    import jax
    return {_dotted(kp): np.asarray(x) for kp, x in
            jax.tree_util.tree_leaves_with_path(tree)}


def _smoke(arch, over):
    """The reference's smoke config of ``arch`` with ``over``; its ``moe``
    entry, a dict, replaces those fields of the config's ``MoEConfig``."""
    import dataclasses
    from repro.configs.base import get_smoke_config
    cfg = get_smoke_config(arch)
    over = dict(over)
    if "moe" in over:
        over["moe"] = dataclasses.replace(cfg.moe, **over["moe"])
    return cfg.replace(**over)


def job_indices(d):
    from jax.sharding import NamedSharding, PartitionSpec as P
    with open(os.path.join(d, "cases.json")) as f:
        cases = json.load(f)
    out = []
    for shape, axes, spec, tshape in cases:
        mesh = _mesh(shape, axes)
        spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
        imap = NamedSharding(mesh, spec).devices_indices_map(tuple(tshape))
        rows = []
        for dev in mesh.devices.reshape(-1):     # mesh order: rank order
            rows.append([[s.start or 0, tshape[i] if s.stop is None
                          else s.stop] for i, s in enumerate(imap[dev])])
        out.append(rows)
    with open(os.path.join(d, "indices.json"), "w") as f:
        json.dump(out, f)


def job_ep(d):
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_smoke_config
    from repro.models import moe as MOE
    from repro.models.model import LM
    from repro.optim import adamw
    from repro.sharding import partition as part

    z = dict(np.load(os.path.join(d, "in.npz")))
    base = get_smoke_config("deepseek-moe-16b")

    def with_cf(cf):
        return base.replace(moe=dataclasses.replace(base.moe,
                                                    capacity_factor=cf))
    cfg = with_cf(8.0)
    p = {k[2:]: jnp.asarray(v) for k, v in z.items() if k.startswith("p.")}
    p = {"router": p["router"], "wi_gate": p["wi_gate"],
         "wi_up": p["wi_up"], "wo": p["wo"],
         "shared": {k: p[f"shared.{k}"] for k in ("wi_gate", "wi_up", "wo")}}
    out = {}

    def run(name, mesh, x, cfg=cfg):
        def f(p, x):
            y, aux = MOE.moe_apply(cfg, p, x)
            return (y ** 2).sum(), (y, aux)
        fn = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
        if mesh is None:
            (_, (y, aux)), (gp, gx) = fn(p, x)
        else:
            with part.activate(mesh):
                (_, (y, aux)), (gp, gx) = fn(p, x)
        out[f"{name}.y"], out[f"{name}.aux"] = np.asarray(y), np.asarray(aux)
        out[f"{name}.g.x"] = np.asarray(gx)
        for k, v in _flat(gp).items():
            out[f"{name}.g.{k}"] = v

    for xi in ("x1", "x2"):
        x = jnp.asarray(z[xi])
        run(f"local.{xi}", None, x)
        for shape in EP_MESHES:
            run(f"ep{shape[0]}{shape[1]}.{xi}",
                _mesh(shape, ("data", "model")), x)
            for cf in z["low_cfs"].tolist():
                run(f"ep{shape[0]}{shape[1]}.{xi}.cf{cf}",
                    _mesh(shape, ("data", "model")), x, with_cf(cf))

    # two AdamW steps of the smoke LM (capacity factor 8) on the (2,2) mesh
    lm = LM(cfg)
    flat = {k[3:]: v for k, v in z.items() if k.startswith("lm.")}
    params = _tree_from(flat, lm.init(jax.random.PRNGKey(0)))
    opt = adamw.OptConfig(**json.loads(str(z["opt"])))
    mesh = _mesh((2, 2), ("data", "model"))
    with part.activate(mesh):
        state = adamw.init_state(params)
        step = jax.jit(adamw.make_train_step(lm, opt))
        for i in range(2):
            state, m = step(state, {"tokens": jnp.asarray(z[f"batch{i}"])})
            for k, v in m.items():
                out[f"train.{i}.{k}"] = np.asarray(v)
            if i == 0:
                for k, v in _flat(state["m"]).items():
                    out[f"train.m1.{k}"] = v
    for k, v in _flat(state["params"]).items():
        out[f"train.params.{k}"] = v
    np.savez(os.path.join(d, "out.npz"), **out)


def _spec_entry(e):
    return list(e) if isinstance(e, tuple) else e


def job_specs(d):
    """Cases: [arch, shape name, mesh shape]."""
    import jax
    from repro.configs.base import SHAPES
    from repro.launch import specs
    with open(os.path.join(d, "cases.json")) as f:
        cases = json.load(f)
    out = []
    for arch, shape, mshape in cases:
        mesh = _mesh(mshape, ("data", "model"))
        sp = specs.input_specs(arch, SHAPES[shape], mesh)
        leaves = {}
        args = jax.tree_util.tree_leaves_with_path(sp["args"])
        shs = jax.tree_util.tree_leaves(
            sp["in_shardings"],
            is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
        for (path, a), sh in zip(args, shs):
            leaves[_dotted(path)] = [list(a.shape), str(a.dtype),
                                     [_spec_entry(e) for e in sh.spec]]
        out.append(leaves)
    with open(os.path.join(d, "specs.json"), "w") as f:
        json.dump(out, f)


def job_flops(d):
    """Cases: [arch, kind, global batch, seq, mesh shape]; the smoke
    config at remat "full", the default implementation (``blocked`` on
    the CPU), as ``launch/dryrun.py``'s ``run_cell``."""
    import jax
    from repro.configs.base import ShapeConfig, get_smoke_config
    from repro.launch import specs
    from repro.roofline import hlo
    from repro.sharding import partition as part
    with open(os.path.join(d, "cases.json")) as f:
        cases = json.load(f)
    out = []
    for arch, kind, B, S, mshape in cases:
        mesh = _mesh(mshape, ("data", "model"))
        shape = ShapeConfig("cell", S, B, kind)
        with part.activate(mesh):
            sp = specs.input_specs(get_smoke_config(arch), shape, mesh,
                                   cfg_overrides={"remat": "full"})
            fn = specs.build_fn(sp)
            co = jax.jit(fn, in_shardings=sp["in_shardings"],
                         out_shardings=sp["out_shardings"],
                         donate_argnums=sp["donate_argnums"]) \
                .lower(*sp["args"]).compile()
        out.append(hlo.analyze_text(co.as_text())["flops"])
    with open(os.path.join(d, "flops.json"), "w") as f:
        json.dump(out, f)


def job_tp(d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.models.model import LM
    from repro.optim import adamw
    from repro.sharding import partition as part
    z = dict(np.load(os.path.join(d, "in.npz")))
    with open(os.path.join(d, "cases.json")) as f:
        cases = json.load(f)
    opt = adamw.OptConfig(**json.loads(str(z["opt"])))
    out = {}
    for name, arch, over, mshape, i in cases:
        lm = LM(_smoke(arch, over))
        pre = f"{name}."
        params = _tree_from({k[len(pre):]: v for k, v in z.items()
                             if k.startswith(pre)},
                            jax.eval_shape(lm.init, jax.random.PRNGKey(0)))
        mesh = _mesh(mshape, ("data", "model"))
        with part.activate(mesh):
            params = jax.device_put(params, part.param_shardings(
                lm.specs(), params, mesh))
            batch = {"tokens": jax.device_put(
                jnp.asarray(z["tokens"]),
                NamedSharding(mesh, part.batch_spec(mesh, 2)))}
            if lm.cfg.encoder_layers:
                batch["frames"] = jax.device_put(
                    jnp.asarray(z["frames"]),
                    NamedSharding(mesh, part.batch_spec(mesh, 3)))

            def case(params, batch):
                logits = lm.forward(params, batch)[0]
                state, m = adamw.make_train_step(lm, opt)(
                    adamw.init_state(params), batch)
                return logits, state, m

            logits, state, m = jax.jit(case)(params, batch)
        out[f"{i}.logits"] = np.asarray(logits)
        for part_ in ("params", "m"):
            for k, v in _flat(state[part_]).items():
                out[f"{i}.{part_}.{k}"] = v
        for k, v in m.items():
            out[f"{i}.{k}"] = np.asarray(v)
    np.savez(os.path.join(d, "out.npz"), **out)


def _index_rows(sharding, shape, mesh):
    imap = sharding.devices_indices_map(tuple(shape))
    return [[[s.start or 0, shape[i] if s.stop is None else s.stop]
             for i, s in enumerate(imap[dev])]
            for dev in mesh.devices.reshape(-1)]


def job_serve(d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs.base import ShapeConfig
    from repro.launch import specs
    from repro.models.model import LM
    from repro.sharding import partition as part
    z = dict(np.load(os.path.join(d, "in.npz")))
    with open(os.path.join(d, "cases.json")) as f:
        cases = json.load(f)
    out, indices = {}, {}
    for key, arch, over, mshape, B, cap in cases:
        cfg = _smoke(arch, over)
        lm = LM(cfg)
        pre = f"{key}.p."
        params = _tree_from({k[len(pre):]: v for k, v in z.items()
                             if k.startswith(pre)},
                            jax.eval_shape(lm.init, jax.random.PRNGKey(0)))
        mesh = _mesh(mshape, ("data", "model"))
        with part.activate(mesh):
            sp = specs.input_specs(cfg, ShapeConfig("p", cap, B, "prefill"),
                                   mesh)
            sd = specs.input_specs(cfg, ShapeConfig("d", cap, B, "decode"),
                                   mesh)
            params = jax.device_put(params, sp["in_shardings"][0])
            prefill = jax.jit(specs.build_fn(sp),
                              in_shardings=sp["in_shardings"],
                              out_shardings=sp["out_shardings"])
            decode = jax.jit(specs.build_fn(sd),
                             in_shardings=sd["in_shardings"],
                             out_shardings=sd["out_shardings"])
            batch = {"tokens": jax.device_put(
                jnp.asarray(z[f"{key}.tokens"]),
                sp["in_shardings"][1]["tokens"])}
            if cfg.encoder_layers:
                batch["frames"] = jax.device_put(
                    jnp.asarray(z[f"{key}.frames"]),
                    sp["in_shardings"][1]["frames"])
            cache, logits = prefill(params, batch)
            out[f"{key}.logits.0"] = np.asarray(logits)
            cache = jax.device_put(cache, sd["in_shardings"][1])
            for k, v in _flat(cache).items():
                out[f"{key}.prefill.{k}"] = v
            dec = z[f"{key}.dec"]
            for i in range(dec.shape[1]):
                cache, logits = decode(params, cache,
                                       jnp.asarray(dec[:, i:i + 1]))
                out[f"{key}.logits.{i + 1}"] = np.asarray(logits)
            for k, v in _flat(cache).items():
                out[f"{key}.decode.{k}"] = v
            shs = jax.tree_util.tree_leaves(
                sd["in_shardings"][1],
                is_leaf=lambda x: isinstance(x, NamedSharding))
            indices[key] = {
                _dotted(path): _index_rows(sh, a.shape, mesh)
                for (path, a), sh in zip(
                    jax.tree_util.tree_leaves_with_path(sd["args"][1]), shs)}
    np.savez(os.path.join(d, "out.npz"), **out)
    with open(os.path.join(d, "indices.json"), "w") as f:
        json.dump(indices, f)


if __name__ == "__main__":
    {"indices": job_indices, "ep": job_ep, "specs": job_specs,
     "flops": job_flops, "tp": job_tp, "serve": job_serve}[sys.argv[1]](
        sys.argv[2])
