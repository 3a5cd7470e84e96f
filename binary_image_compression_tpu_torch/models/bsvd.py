"""Binary dictionary learning (BSVD), the GF(2) K-SVD analog, in PyTorch.

Counterpart of ``binary_image_compression_tpu/models/bsvd.py``.  Model
(reference bsvd.h:31-37): X (N x M patch rows) ~ A (N x K coefficients) *
D (K x M atoms) over GF(2), E = X ^ A*D, minimizing |E| or an MDL
codelength.

* The pursuit (``update_coefficients``) flips, per sweep, each sample's
  single best coefficient while that lowers |E_i|.  On the packed route
  (``distances="packed"``, the port's default, at any row width) each
  row walks its own loop of distance passes d[i, k] = |E_i ^ D_k| and
  flips on the packed rows, in one launch of the pursuit kernel
  (``ops/packed_dist.packed_pursuit``, K5 with K6 fused in).  The
  ``"mxu"`` route sweeps all rows at once with one float32 product per
  sweep.  The ``"gram"`` route sweeps too, but carries the products
  <E_i, D_k> from sweep to sweep: G = D D^T once per call, then one
  correction product per sweep.  All three give the same integers, so the
  same flips.
* The dictionary updates are majority votes, atom after atom, each fixing
  up E before the next: a serial chain by the reference's semantics
  (bsvd.cpp:463-735), a Python loop over tensors here.
* The initializers split into a draw and a deterministic core.  The draw
  is a numpy replay of JAX's threefry keys (``utils/threefry``), made on
  the host and moved to the device, and the drivers split keys in JAX's
  order; so for the same seed a CPU run, a CUDA run and the JAX package
  start from the same state, and codec 11 writes JAX's stream.

State is dense int8 0/1, as in the JAX package.  Every product is float32
over 0/1 operands with sums below 2**24, so it is an exact integer, with
TF32 on or off; ``update_dictionary_*``, the mxu route, ``residual``
and the initializers depend on that.  No fp16 or bf16 anywhere, and no int8
``torch.matmul`` (CUDA has none).  JAX's ``lax.while_loop`` conditions
become one ``.item()`` per sweep on the mxu and gram routes; the packed
route's pursuit has no host sync.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import bitpack, packed_dist
from ..ops.entropy import universal_codelength_t as _ucl
from ..utils import threefry

# the forms of d[i, k] (``distances_to_atoms``), and the pursuit's routes
DISTANCE_FORMS = ("packed", "mxu")
DISTANCES = DISTANCE_FORMS + ("gram",)

_F32 = torch.float32


def _f32(x):
    return x.to(_F32)


def _pack(rows):
    """0/1 [N, M] -> int32 [N, nwords(M)] words for K5 and the pursuit."""
    return bitpack.to_i32(bitpack.pack(rows)).contiguous()


def _check_distances(distances: str, allowed=DISTANCES) -> None:
    if distances not in allowed:
        raise ValueError(f"distances={distances!r}: one of {allowed}")


def distances_to_atoms(E, D, impl: str = "packed"):
    """d[i, k] = |E_i ^ D_k| for dense 0/1 rows E [N, M], D [K, M].

    impl="packed": K5 on the packed rows, int32, any M.  impl="mxu": one
    float32 product, |E_i| + |D_k| - 2 <E_i, D_k>.  Every value is an exact
    integer in both forms."""
    _check_distances(impl, DISTANCE_FORMS)
    if impl == "packed":
        return packed_dist.packed_dist_matrix(_pack(E), _pack(D))
    we = E.sum(dim=1, dtype=_F32)
    wd = D.sum(dim=1, dtype=_F32)
    cross = _f32(E) @ _f32(D).T
    return we[:, None] + wd[None, :] - 2.0 * cross


def update_coefficients(E, D, A, max_flips: int | None = None,
                        distances: str = "packed"):
    """Greedy Hamming pursuit, vectorized over samples.

    Per sweep every still-improving sample flips the one coefficient whose
    atom most lowers |E_i| (the first minimum, as ``jnp.argmin``); sweeps
    repeat until no sample improves, at most `max_flips` (default K) times.
    Returns (E', A', changed_count) with changed_count an int64 tensor; the
    inputs are left alone.

    A sample's state changes only when it improves, so each row's outcome is
    its own loop.  The packed route packs E and D once and runs it in one
    ``packed_dist.packed_pursuit`` call on a copy of A (one kernel launch on
    the card, no host sync), then unpacks E.  The mxu route sweeps: one
    float32 product per sweep for d, |E_i| carried, one host sync per
    sweep.  The gram route (``_update_coefficients_gram``) sweeps with the
    products carried."""
    _check_distances(distances)
    N, M = E.shape
    K = D.shape[0]
    if max_flips is None:
        max_flips = K
    if distances == "packed":
        Ep = _pack(E)
        A = A.clone(memory_format=torch.contiguous_format)
        changed, _ = packed_dist.packed_pursuit(Ep, _pack(D), A, max_flips)
        return bitpack.unpack(Ep, M).to(E.dtype), A, changed
    if distances == "gram":
        return _update_coefficients_gram(E, D, A, max_flips)
    w = E.sum(dim=1, dtype=_F32)
    ks = torch.arange(K, device=E.device)
    active = torch.ones((N,), dtype=torch.bool, device=E.device)
    changed = torch.zeros((N,), dtype=torch.bool, device=E.device)
    it = 0
    while it < max_flips and bool(active.any()):
        d = distances_to_atoms(E, D, "mxu")
        bestk = torch.argmin(d, dim=1)
        bestd = d.gather(1, bestk[:, None])[:, 0]
        improve = (bestd < w) & active
        sel = (bestk[:, None] == ks[None, :]).to(A.dtype)
        A = torch.where(improve[:, None], A ^ sel, A)
        E = torch.where(improve[:, None], E ^ D[bestk], E)
        w = torch.where(improve, bestd, w)
        changed |= improve
        active = improve
        it += 1
    return E, A, changed.sum()


def _update_coefficients_gram(E, D, A, max_flips: int):
    """The Gram / cross-carry sweep (JAX ``_update_coefficients_gram``): the
    reference's update_coefficients_fast (bsvd.cpp:1116-1213) done right
    over GF(2).  cross[i, k] = <E_i, D_k> and |E_i| are carried; a flip
    E_i ^= D_b changes cross by the exact identity

        <E_i ^ D_b, D_k> = <E_i, D_k> + G[b, k] - 2 <E_i & D_b, D_k>

    with G = D D^T formed once, so a sweep costs one product, <E_i & D_b,
    D_k> over the improving rows, in place of the distance product.  Every
    value is an exact integer in float32, so the flips are the mxu
    route's.  One host sync per sweep."""
    N = E.shape[0]
    K = D.shape[0]
    Df = _f32(D)
    wd = D.sum(dim=1, dtype=_F32)
    G = Df @ Df.T
    cross = _f32(E) @ Df.T
    w = E.sum(dim=1, dtype=_F32)
    ks = torch.arange(K, device=E.device)
    active = torch.ones((N,), dtype=torch.bool, device=E.device)
    changed = torch.zeros((N,), dtype=torch.bool, device=E.device)
    it = 0
    while it < max_flips and bool(active.any()):
        d = w[:, None] + wd[None, :] - 2.0 * cross
        bestk = torch.argmin(d, dim=1)
        bestd = d.gather(1, bestk[:, None])[:, 0]
        improve = (bestd < w) & active
        sel = (bestk[:, None] == ks[None, :]).to(A.dtype)
        A = torch.where(improve[:, None], A ^ sel, A)
        atom = D[bestk]
        T = _f32((E & atom) * improve[:, None]) @ Df.T
        cross = torch.where(improve[:, None], cross + G[bestk] - 2.0 * T,
                            cross)
        w = torch.where(improve, bestd, w)
        E = torch.where(improve[:, None], E ^ atom, E)
        changed |= improve
        active = improve
        it += 1
    return E, A, changed.sum()


def update_dictionary_steepest(E, D, A, allreduce=None):
    """Majority-vote atom update with sequential residual fixup
    (bsvd.cpp:463-527): per atom k over its users U = {i : A[i, k]},
    weights_j = sum_U (E_i ^ D_k)_j, new D_k = weights > floor(|U| / 2);
    the users' rows of E take the change before the next atom.  Atoms are
    serial.  Returns (E', D', atoms_changed) without touching the inputs.

    allreduce: where the rows of E and A are split over ranks
    (``parallel/mesh.sharded_train_step``), a function that sums a float32
    tensor over them in place; each atom's vote [usage, weights] is one
    such sum, so every rank takes the same D_k."""
    E, D = E.clone(), D.clone()
    K = D.shape[0]
    changed = torch.zeros((), dtype=torch.int64, device=E.device)
    for k in range(K):
        Dk = D[k].clone()
        users = A[:, k]
        usage = users.sum(dtype=_F32)
        weights = _f32(users)[None, :] @ _f32(E ^ Dk[None, :])
        if allreduce is not None:
            vote = torch.cat([usage.reshape(1, 1), weights], dim=1)
            allreduce(vote)
            usage, weights = vote[0, 0], vote[:, 1:]
        newDk = (weights[0] > torch.floor(usage / 2.0)).to(D.dtype)
        newDk = torch.where(usage > 0, newDk, Dk)
        delta = Dk ^ newDk
        changed += (delta.sum() > 0).to(torch.int64)
        E ^= users[:, None] * delta[None, :]
        D[k] = newDk
    return E, D, changed


def update_dictionary_proximus(E, D, A, max_inner: int = 8):
    """PROXIMUS rank-one alternation per atom (bsvd.cpp:530-735): majority
    updates of D_k over its users and of A[:, k] over D_k's support, each
    with its residual fixup, until neither changes (at most `max_inner`
    rounds); atoms serial.  Returns (E', D', A', atoms_changed)."""
    E, D, A = E.clone(), D.clone(), A.clone()
    K = D.shape[0]
    changed = 0
    for k in range(K):
        kch = False
        for _ in range(max_inner):
            Dk = D[k].clone()
            Ak = A[:, k].clone()
            usage = Ak.sum(dtype=_F32)
            w = _f32(Ak)[None, :] @ _f32(E ^ Dk[None, :])
            newDk = (w[0] > torch.floor(usage / 2.0)).to(D.dtype)
            newDk = torch.where(usage > 0, newDk, Dk)
            dd = (newDk ^ Dk).sum()
            E ^= Ak[:, None] * (Dk ^ newDk)[None, :]
            D[k] = newDk
            sup = newDk.sum(dtype=_F32)
            v = _f32(E ^ Ak[:, None]) @ _f32(newDk)[:, None]
            newAk = (v[:, 0] > torch.floor(sup / 2.0)).to(A.dtype)
            newAk = torch.where(sup > 0, newAk, Ak)
            da = (newAk ^ Ak).sum()
            E ^= (Ak ^ newAk)[:, None] * newDk[None, :]
            A[:, k] = newAk
            dd, da = torch.stack([dd, da]).tolist()
            kch = kch or dd > 0
            if dd == 0 and da == 0:
                break
        changed += int(kch)
    return E, D, A, torch.tensor(changed, device=E.device)


# --- initializers: a draw (a threefry key) and a deterministic core --------
# `key` is a ``utils/threefry`` key; each draw equals JAX's from that key.


def _random_from_bits(X, D):
    """Core of ``initialize_random``: the drawn atoms, no coefficients."""
    N = X.shape[0]
    D = torch.as_tensor(D).to(device=X.device, dtype=torch.int8)
    return D, torch.zeros((N, D.shape[0]), dtype=torch.int8, device=X.device)


def initialize_random(key, X, K):
    """Bernoulli(0.5) atoms (initialize_model_random, bsvd.cpp:385-397)."""
    bits = threefry.bernoulli(key, 0.5, (K, X.shape[1]))
    return _random_from_bits(X, torch.from_numpy(bits))


def _centroids_from_assign(X, assign, K):
    """Core of ``initialize_random_centroids``: majority centroid of each
    assigned cluster (an empty cluster gives the all-ones atom)."""
    assign = torch.as_tensor(assign).to(device=X.device, dtype=torch.int64)
    onehot = _f32(assign[:, None] == torch.arange(K, device=X.device))
    counts = onehot.sum(dim=0)
    sums = onehot.T @ _f32(X)
    D = (2.0 * sums >= counts[:, None]).to(torch.int8)
    return D, onehot.to(torch.int8)


def initialize_random_centroids(key, X, K):
    """Random cluster assignment + majority centroid (bsvd.cpp:128-166)."""
    assign = threefry.randint(key, (X.shape[0],), 0, K)
    return _centroids_from_assign(X, torch.from_numpy(assign), K)


def _neighbor_from_idx(X, idx, K):
    """Core of ``initialize_neighbor``: for each seed row, the centroid of
    (X_j AND seed) over the rows sharing a set bit with it."""
    N = X.shape[0]
    idx = torch.as_tensor(idx).to(device=X.device, dtype=torch.int64)
    seeds = X[idx]
    Xf = _f32(X)
    mask = _f32((_f32(seeds) @ Xf.T) > 0)
    u = mask.sum(dim=1)
    s = (mask @ Xf) * _f32(seeds)
    D = (s >= torch.floor(u[:, None] / 2.0)).to(torch.int8)
    D = torch.where((u > 0)[:, None], D, seeds.to(torch.int8))
    return D, torch.zeros((N, K), dtype=torch.int8, device=X.device)


def initialize_neighbor(key, X, K):
    """Neighbor-centroid init (bsvd.cpp:227-267) from K random seed rows."""
    idx = threefry.randint(key, (K,), 0, X.shape[0])
    return _neighbor_from_idx(X, torch.from_numpy(idx), K)


def initialize_partition(key, X, K):
    """Weight-ranked pivot-column partition (bsvd.cpp:173-219); no draw.

    Columns ranked by weight descending, ties by ascending index; atom k is
    the majority centroid of the samples hot in the k-th ranked column;
    zero atoms pad K > M.  `key` is unused (the INITIALIZERS signature)."""
    N, M = X.shape
    colw = X.to(torch.int64).sum(dim=0)
    keyv = (-colw) * M + torch.arange(M, device=X.device)
    pivots = torch.argsort(keyv)[:min(K, M)]
    users = _f32(X[:, pivots]).T
    u = users.sum(dim=1)
    s = users @ _f32(X)
    D = (s >= torch.floor(u[:, None] / 2.0)).to(torch.int8)
    if D.shape[0] < K:
        D = torch.nn.functional.pad(D, (0, 0, 0, K - D.shape[0]))
    return D, torch.zeros((N, K), dtype=torch.int8, device=X.device)


def _graph_grow_from_seeds(X, seed_idx, K):
    """Core of ``initialize_graph_grow`` (JAX bsvd.py:307): untaken nonzero
    rows are dealt to atoms 0..K-1 round-robin in ascending order (the
    reference's never-reset score makes its search exactly that), every
    row counts toward the part sizes, and each atom is its part's
    majority centroid."""
    N, M = X.shape
    seed_idx = torch.as_tensor(seed_idx).to(device=X.device,
                                            dtype=torch.int64)
    taken = torch.zeros((N,), dtype=torch.bool, device=X.device)
    taken[seed_idx] = True
    dealt = (~taken) & (X.to(torch.int64).sum(dim=1) > 0)
    t = torch.cumsum(dealt.to(torch.int64), dim=0) - 1
    atom = torch.where(dealt, t % K, -1)
    onehot = _f32(atom[:, None] == torch.arange(K, device=X.device))
    s = onehot.T @ _f32(X) + _f32(X[seed_idx])
    deals_total = N - K
    extra = (deals_total // K) + (torch.arange(K, device=X.device)
                                  < deals_total % K).to(torch.int64)
    u = _f32(1 + extra)
    D = (s >= torch.floor(u[:, None] / 2.0)).to(torch.int8)
    return D, torch.zeros((N, K), dtype=torch.int8, device=X.device)


def initialize_graph_grow(key, X, K, seed_idx=None):
    """Support-graph growing init (bsvd.cpp:286-383) from K distinct random
    seed rows; `seed_idx` overrides the draw."""
    N = X.shape[0]
    if seed_idx is None:
        if K > N:
            raise ValueError(f"graph_grow needs K <= N distinct seed rows "
                             f"(K={K}, N={N})")
        seed_idx = torch.from_numpy(threefry.choice(key, N, K))
    return _graph_grow_from_seeds(X, seed_idx, K)


INITIALIZERS = {
    "neighbor": initialize_neighbor,
    "random_centroids": initialize_random_centroids,
    "random": initialize_random,
    "partition": initialize_partition,
    "graph_grow": initialize_graph_grow,
}


@dataclass
class LearnConfig:
    """``learn``'s settings (JAX ``bsvd.LearnConfig``)."""
    K: int = 64
    init: str = "neighbor"
    dict_update: str = "steepest"
    max_iters: int = 30
    seed: int = 34503498  # the reference's global default (bsvd.cpp:23)


# --- drivers ---------------------------------------------------------------

def residual(X, D, A):
    """E = X ^ (A*D mod 2), one float32 product."""
    prod = _f32(A) @ _f32(D)
    return X ^ torch.remainder(prod, 2.0).to(X.dtype)


def _dict_update(dict_update, E, D, A):
    """One dictionary update; returns (E, D, A, atoms_changed)."""
    if dict_update == "proximus":
        return update_dictionary_proximus(E, D, A)
    E, D, ch = update_dictionary_steepest(E, D, A)
    return E, D, A, ch


def learn_from(X, D, A, dict_update: str = "steepest", max_iters: int = 30,
               distances: str = "packed"):
    """learn_model_traditional from a given (D, A) (bsvd.cpp:1215-1244):
    alternate the pursuit and the dictionary update until nothing changes,
    at most `max_iters` times.  Returns (E, D, A, iters)."""
    E = residual(X, D, A)
    it, changed = 0, 1
    while changed > 0 and it < max_iters:
        E, A, ch_coefs = update_coefficients(E, D, A, distances=distances)
        E, D, A, ch_atoms = _dict_update(dict_update, E, D, A)
        changed = int(ch_coefs + ch_atoms)
        it += 1
    return E, D, A, it


def learn(X, K: int, init: str = "neighbor", dict_update: str = "steepest",
          max_iters: int = 30, seed: int = 34503498,
          distances: str = "packed"):
    """Initialize from `seed`, then ``learn_from``.  X: int8 [N, M] on the
    device to learn on.  Returns (E, D, A, iters)."""
    D, A = INITIALIZERS[init](threefry.PRNGKey(seed), X, K)
    return learn_from(X, D, A, dict_update=dict_update, max_iters=max_iters,
                      distances=distances)


def learn_alter(X, K: int, init: str = "neighbor", variant: int = 1,
                dict_update: str = "steepest", max_iters: int = 10,
                seed: int = 34503498):
    """Role-switching learning loops (learn_model_alter1/2/3,
    bsvd.cpp:1247-1434).  The transposed model treats A^T as the dictionary
    of E^T: variant 1 alternates a direct and a transposed pass each outer
    iteration; variant 2 runs each orientation to convergence before
    switching; variant 3 applies only the dictionary update in both
    orientations.  Returns (E, D, A, iters)."""
    D, A = INITIALIZERS[init](threefry.PRNGKey(seed), X, K)
    E = residual(X, D, A)

    def direct(E, D, A):
        E, A, c1 = update_coefficients(E, D, A)
        E, D, A, c2 = _dict_update(dict_update, E, D, A)
        return E, D, A, int(c1 + c2)

    def transposed(E, D, A):
        Et, Dt, At = (E.T.contiguous(), A.T.contiguous(), D.T.contiguous())
        if variant != 3:
            Et, At, _ = update_coefficients(Et, Dt, At)
        Et, Dt, At, ch = _dict_update(dict_update, Et, Dt, At)
        return (Et.T.contiguous(), At.T.contiguous(), Dt.T.contiguous(),
                int(ch))

    def to_convergence(step, E, D, A):
        ch, tot, it = 1, 0, 0
        while ch > 0 and it < max_iters:
            E, D, A, ch = step(E, D, A)
            tot += ch
            it += 1
        return E, D, A, tot

    it, changed = 0, 1
    while changed > 0 and it < max_iters:
        if variant == 3:
            E, D, A, ch1 = transposed(E, D, A)
            E, D, A, ch2 = _dict_update(dict_update, E, D, A)
            ch2 = int(ch2)
        elif variant == 2:
            E, D, A, ch1 = to_convergence(direct, E, D, A)
            E, D, A, ch2 = to_convergence(transposed, E, D, A)
        else:
            E, D, A, ch1 = direct(E, D, A)
            E, D, A, ch2 = transposed(E, D, A)
        changed = ch1 + ch2
        it += 1
    return residual(X, D, A), D, A, it


def learn_mdl_forward(X, K0: int = 4, init: str = "neighbor",
                      dict_update: str = "steepest", seed: int = 34503498,
                      max_k: int = 256, stuck_limit: int = 10,
                      verbose: bool = False):
    """MDL forward selection (bsvd.cpp:1463-1546): grow the dictionary one
    atom at a time, the new atom initialized from the current residual and
    the whole model re-learned, keeping the best codelength under the
    reference's stuck-counter and mean-deviation rule.  The first model
    draws from the seed's key, each new atom from the next split of it
    (JAX's order).  Returns (E, D, A, bestL)."""
    key = threefry.PRNGKey(seed)
    E, D, A, _ = learn(X, K0, init=init, dict_update=dict_update, seed=seed)
    bestL = float(model_codelength(E, D, A))
    best = (E, D, A)
    currE, currD, currA = E, D, A
    stuck = sum_stuck = all_stuck = 0
    K = K0
    while stuck < stuck_limit and K < max_k:
        dev = (sum_stuck // all_stuck) if all_stuck else 0
        key, sub = threefry.split(key)
        atomD, _ = INITIALIZERS[init](sub, currE, 1)
        currD = torch.cat([currD, atomD.to(currD.dtype)], dim=0)
        currA = torch.nn.functional.pad(currA, (0, 1))
        currE, currD, currA, _ = learn_from(X, currD, currA,
                                            dict_update=dict_update)
        currL = float(model_codelength(currE, currD, currA))
        if verbose:
            print(f"currK={K + 1} currL={currL:.0f} bestL={bestL:.0f} "
                  f"stuck={stuck} dev={dev}")
        if currL + dev < bestL:
            stuck = 0
            bestL = currL
            best = (currE, currD, currA)
        else:
            stuck += 1
            all_stuck += 1
            sum_stuck += currL - bestL
        K += 1
    E, D, A = best
    return E, D, A, bestL


def learn_mdl_backward(X, K0: int = 32, init: str = "random_centroids",
                       dict_update: str = "steepest", seed: int = 34503498,
                       stuck_limit: int = 10):
    """MDL backward selection (bsvd.cpp:1548-1663): start at K0 atoms and
    remove, one at a time, the atom whose removal scores the lowest
    codelength, re-learning after each removal, while the stuck-counter
    rule allows.  The scores of all atoms come from one product:
    |E ^ A_k (x) D_k| = |E| + |A_k||D_k| - 2 rowsum((A^T E) * D).
    Returns (E, D, A, bestL)."""
    N, M = X.shape
    E, D, A, _ = learn(X, K0, init=init, dict_update=dict_update, seed=seed)
    bestL = float(model_codelength(E, D, A))
    best = (E, D, A)
    stuck = sum_stuck = all_stuck = 0
    currE, currD, currA = E, D, A
    while currD.shape[0] > 1:
        dev = (sum_stuck // all_stuck) if all_stuck else 0
        K = currD.shape[0]
        wA = currA.sum(dim=0, dtype=_F32)
        wD = currD.sum(dim=1, dtype=_F32)
        overlap = ((_f32(currA).T @ _f32(currE)) * _f32(currD)).sum(dim=1)
        wE = currE.sum(dtype=_F32)
        wEk = wE + wA * wD - 2.0 * overlap
        tmpL = (_ucl(N * M, wEk) - _ucl(M, currD.sum(dim=1))
                - _ucl(N, currA.sum(dim=0)))
        nextk = int(torch.argmin(tmpL))
        keep = torch.tensor([k for k in range(K) if k != nextk],
                            device=X.device)
        currE, currD, currA, _ = learn_from(X, currD[keep], currA[:, keep],
                                            dict_update=dict_update)
        currL = float(model_codelength(currE, currD, currA))
        if currL + dev < bestL:
            stuck = 0
            bestL = currL
            best = (currE, currD, currA)
        else:
            stuck += 1
            all_stuck += 1
            sum_stuck += currL - bestL
            if stuck >= stuck_limit:
                break
    E, D, A = best
    return E, D, A, bestL


def learn_mdl_full(X, Kmax: int = 40, Kstep: int = 20, reps: int = 10,
                   init: str = "random_centroids",
                   dict_update: str = "steepest", seed: int = 34503498):
    """MDL full search (bsvd.cpp:1665-1717): K in steps of Kstep up to
    Kmax, `reps` restarts each, keeping the
    lowest codelength (the first on a tie).  Each restart draws from the
    next split of the seed's key.  Returns (E, D, A, bestL)."""
    key = threefry.PRNGKey(seed)
    best = bestL = None
    K = Kstep
    while K <= Kmax:
        for _ in range(reps):
            key, sub = threefry.split(key)
            D0, A0 = INITIALIZERS[init](sub, X, K)
            E, D, A, _ = learn_from(X, D0, A0, dict_update=dict_update)
            L = float(model_codelength(E, D, A))
            if bestL is None or L < bestL:
                bestL = L
                best = (E, D, A)
        K += Kstep
    E, D, A = best
    return E, D, A, bestL


def learn_train_step(E, D, A, allreduce=None):
    """One alternation step (JAX bsvd.py:642): a pursuit of at most 4 flips
    per row, then the steepest dictionary update; the unit the sharded step
    runs (``parallel/mesh.sharded_train_step``, which passes `allreduce`).
    Returns (E, D, A)."""
    E, A, _ = update_coefficients(E, D, A, max_flips=4)
    E, D, _ = update_dictionary_steepest(E, D, A, allreduce=allreduce)
    return E, D, A


def model_codelength(E, D, A):
    """MDL score (bsvd.cpp:1438-1461) in float32: |E| over N*M positions,
    each atom over M and each coefficient column over N."""
    N, M = E.shape
    LE = _ucl(N * M, E.sum())
    LD = _ucl(M, D.sum(dim=1)).sum()
    LA = _ucl(N, A.sum(dim=0)).sum()
    return LE + LD + LA


def patchify_to_rows(img_bits, W: int):
    """Image [rows, cols] -> X rows int8 [Ny*Nx, W*W], tiles in raster order
    (the bsvd_test -I 1 path, bsvd_test.cpp:78-100)."""
    tiles = bitpack.patchify(torch.as_tensor(img_bits), W)
    return tiles.reshape(tiles.shape[0], W * W).to(torch.int8)


# --- carrying state across -------------------------------------------------

def state_from_jax(D, A, *, device):
    """The JAX package's (D, A), as numpy (``np.asarray``), -> int8 tensors
    on `device`."""
    return tuple(torch.from_numpy(np.asarray(x).astype(np.int8)).to(device)
                 for x in (D, A))


def state_to_numpy(*tensors):
    """Port tensors -> int8 numpy arrays, the JAX package's dtype."""
    return tuple(t.detach().to("cpu", torch.int8).numpy() for t in tensors)
