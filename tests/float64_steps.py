"""Two AdamW steps of a float64 copy of the port (``tests/
encdec_grad_norm.py``'s ``float64_port``) on a mesh, held against the same
steps unsharded: the measure that the tensor-parallel tests share
(``test_torch_tp_encdec.py``, ``test_torch_tp_scan.py``,
``test_torch_tp_moe.py``, ``test_torch_tp_ep.py``).

Every term is held at F64_REL:

* loss and grad_norm at both steps, relative;
* ``m`` and ``v`` after step 1, leaf by leaf, relative L2 (``m`` carries
  the clipped gradient, ``v`` its square);
* the params after step 2, each element's absolute difference times its
  gradient's share of the leaf: the smaller, over the two steps, of
  ``|g| / max |g|`` in the unsharded run.

Why the params are weighted: AdamW divides each element's step by that
element's own sqrt(v), so float64 noise of rho * max|g| in a gradient moves
a param by up to lr * rho * max|g| / |g|. Step 1's updates carry such noise
into step 2's gradients at rho of some 1e-10, and an element whose gradient
is 3e-6 of its leaf's largest then moves by 3e-10 on one host and less on
another (seamless-m4t's ``embed``). The weight undoes that division,
leaving at most lr * rho, some 1e-13, while an update that goes wrong moves
every element with a gradient by about lr.

The witness, computed beside the unsharded steps in each run: the same
steps with their products' sums taken in parts (``sums_in_parts``), a pure
reordering, whose params term must stay under F64_REL as well.
"""
import contextlib
from collections import namedtuple

import torch

from repro_torch.optim.adamw import OptConfig

F64_REL = 1e-10
B1 = OptConfig().b1    # the tests' steps keep OptConfig's b1
PARTS = 4              # the witness's parts: the model axis of (1, 4)

# metrics per step; params after step 2; m and v after step 1; m after
# step 2; step 1's logits where a test records them
Steps = namedtuple("Steps", "metrics params m1 v1 m2 logits",
                   defaults=(None,))


def two_steps(step, state, batches, whole):
    """Runs ``step`` from ``state`` on each of the two ``batches``.
    ``whole(t)`` makes a state leaf a whole tensor. -> ``Steps``."""
    def snap(tree):
        return {n: whole(t).detach().clone() for n, t in tree.items()}
    mets = []
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        mets.append({k: float(v) for k, v in m.items()})
        if i == 0:
            m1, v1 = snap(state["m"]), snap(state["v"])
    return Steps(mets, snap(state["params"]), m1, v1, snap(state["m"]))


def _rel_l2(a, b):
    n = b.norm()
    return float((a - b).norm() / n) if n > 0 else float((a - b).norm())


def _share(g):
    """|g| over the leaf's largest |g| (0 where the leaf has none)."""
    a = g.abs()
    top = a.max()
    return a / top if top > 0 else a


def distance(got, want):
    """{term: reading} of ``got`` against ``want``, both ``Steps``."""
    def rel(a, b):
        return abs(a - b) / abs(b)
    out = {k: max(rel(a[k], b[k]) for a, b in zip(got.metrics,
                                                   want.metrics))
           for k in ("loss", "grad_norm")}
    out["grad_norm_by_step"] = [rel(a["grad_norm"], b["grad_norm"])
                                for a, b in zip(got.metrics, want.metrics)]
    for k in ("m1", "v1"):
        a, b = getattr(got, k), getattr(want, k)
        out[k] = max(_rel_l2(a[n], b[n]) for n in b)
    worst = 0.0
    for n, p in want.params.items():
        m1, m2 = want.m1[n], want.m2[n]
        weight = torch.minimum(_share(m1), _share(m2 - B1 * m1))
        worst = max(worst, float(((got.params[n] - p).abs() * weight)
                                 .max()))
    out["params"] = worst
    return out


def worst(got, want):
    """The largest term of ``distance``, the one held at F64_REL."""
    return worst_of(distance(got, want))


def worst_of(d):
    """The largest term of a ``distance`` reading ``d``."""
    return max(v for k, v in d.items() if k != "grad_norm_by_step")


@contextlib.contextmanager
def sums_in_parts(n=PARTS):
    """Every ``a @ b`` whose contraction and output dims ``n`` divides,
    taken as ``n`` column groups, each the sum of ``n`` partial products:
    the forward sums as a row-parallel split sums them and the backward's
    input gradient as a column-parallel one does. The witness of the
    mesh's order of sums, in one process (as ``chip_smoke.py``'s
    ``_sums_in_parts`` on the card). It runs on one thread: beside other
    test processes each of its many small products would otherwise wait
    for threads that they hold."""
    real, threads = torch.Tensor.__matmul__, torch.get_num_threads()

    def matmul(a, b):
        if a.dim() < 2 or b.dim() < 2 or a.shape[-1] % n or b.shape[-1] % n:
            return real(a, b)
        k, c = a.shape[-1] // n, b.shape[-1] // n
        return torch.cat([torch.stack([
            real(a[..., i * k:(i + 1) * k],
                 b[..., i * k:(i + 1) * k, j * c:(j + 1) * c])
            for i in range(n)]).sum(0) for j in range(n)], -1)
    torch.Tensor.__matmul__ = matmul
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = real
        torch.set_num_threads(threads)
