"""Reference-parity BSVD: exact numpy replay of bsvd.cpp.

Reproduces the reference's dictionary learning bit-for-bit — same rand48
stream (utils/rand48.py == GSL gsl_rng_rand48), same update order, same
integer thresholds — validated against goldens (learned D/A/E PBM digests
and final |E|, scripts/gen_goldens.py).  The device path is
models/bsvd.py; this module is the conformance layer and the drop-in for
users who need the reference's exact outputs (``bsvd --backend ref``,
codec 11's ``learn_backend="ref"``).  A copy of
``binary_image_compression_tpu/models/bsvd_ref.py``, plain numpy.

Algorithm catalogs mirror learn_model_setup (bsvd.cpp:25-96).
"""

from __future__ import annotations

import numpy as np

from ..utils.rand48 import Rand48

# module-level RNG singleton, as the reference's get_rng (bsvd.cpp:8-15)
_rng: Rand48 | None = None
random_seed = 34503498  # bsvd.cpp:23


def _get_rng() -> Rand48:
    global _rng
    if _rng is None:
        _rng = Rand48(random_seed)
    return _rng


def reset_rng(seed: int | None = None) -> None:
    """Fresh process-equivalent: clear the singleton (new seed optional)."""
    global _rng, random_seed
    if seed is not None:
        random_seed = seed
    _rng = None


def col_weight_ref(E: np.ndarray, j: int) -> int:
    """binary_matrix::col_weight INCLUDING its loop-bound bug
    (binmat.cpp:83-92): with bpr = ceil(cols/64) blocks per row, only rows
    i*bpr < n are visited, undercounting by ~bpr for multi-block rows."""
    n, m = E.shape
    bpr = -(-m // 64)
    visited = (n + bpr - 1) // bpr  # #{t : t*bpr < n}
    return int(E[:visited, j].sum())


def _counting_sort_exact(pairs):
    """util.cpp:7-51: ascending by key; processes input back-to-front so
    equal keys end up in REVERSED original order."""
    n = len(pairs)
    maxs = max((p[0] for p in pairs), default=0)
    count = [0] * (maxs + 2)
    for f, _ in pairs:
        count[f + 1] += 1
    for i in range(1, maxs + 2):
        count[i] += count[i - 1]
    scratch = [None] * n
    for i in range(n - 1, -1, -1):
        c = pairs[i][0]
        scratch[count[c]] = pairs[i]
        count[c] += 1
    return scratch


# ---------------------------------------------------------------------------
# initializers (bsvd.cpp:99-397)
# ---------------------------------------------------------------------------

def initialize_neighbor(E, D, A):
    """bsvd.cpp:227-267."""
    n, m = E.shape
    p = D.shape[0]
    rng = _get_rng()
    A[:] = 0
    D[:] = 0
    k = 0
    while k < p:
        i = rng.uniform_int(n)
        Ei = E[i]
        if Ei.sum() == 0:
            continue
        inter = E & Ei[None, :]
        nz = inter.any(axis=1)
        u = int(nz.sum())
        s = inter[nz].sum(axis=0)
        if u > 0:
            D[k] = s >= (u // 2)
            k += 1


def initialize_partition(E, D, A):
    """bsvd.cpp:173-219 (col_weight bug included)."""
    n, m = E.shape
    p = D.shape[0]
    A[:] = 0
    D[:] = 0
    ranking = _counting_sort_exact(
        [(col_weight_ref(E, k), k) for k in range(m)])
    for k in range(min(p, m)):
        pivot = ranking[m - k - 1][1]
        users = E[:, pivot]
        u = int(users.sum())
        s = E[users.astype(bool)].sum(axis=0)
        D[k] = s >= (u // 2)   # u == 0 -> all-ones row, as in the reference


def initialize_random_centroids(E, D, A):
    """bsvd.cpp:128-166."""
    n, m = E.shape
    p = D.shape[0]
    rng = _get_rng()
    A[:] = 0
    D[:] = 0
    s = np.zeros((p, m), dtype=np.int64)
    u = np.zeros(p, dtype=np.int64)
    for i in range(n):
        k = rng.uniform_int(p)
        A[i, k] = True
        u[k] += 1
        s[k] += E[i]
    D[:] = 2 * s >= u[:, None]   # u == 0 -> all-ones row


def initialize_random_centroids_xor(E, D, A):
    """bsvd.cpp:99-126."""
    n, m = E.shape
    p = D.shape[0]
    rng = _get_rng()
    A[:] = 0
    D[:] = 0
    for i in range(n):
        k = rng.uniform_int(p)
        A[i, k] = True
        D[k] ^= E[i]


def initialize_graph_grow(E, D, A):
    """bsvd.cpp:286-383 (score-never-reset quirk included: the 'best
    newcomer' is simply the first untaken nonzero row)."""
    n, m = E.shape
    p = D.shape[0]
    rng = _get_rng()
    A[:] = 0
    D[:] = 0
    s = np.zeros((p, m), dtype=np.int64)
    u = np.zeros(p, dtype=np.int64)
    taken = np.zeros(n, dtype=bool)
    left = n
    k = 0
    while left >= 0 and k < p:
        while True:
            i = rng.uniform_int(n)
            if not taken[i]:
                break
        s[k] = E[i].astype(np.int64)
        taken[i] = True
        left -= 1
        u[k] = 1
        k += 1
    while left > 0:
        for k in range(p):
            if left <= 0:
                break
            maxi = 0
            maxscore = 0
            score = 0
            for i in range(n):
                if taken[i]:
                    continue
                if E[i].any():
                    score = 1  # never reset between rows (bsvd.cpp:334-338)
                if score > maxscore:
                    maxscore = score
                    maxi = i
            if maxscore == 0:
                while True:
                    i = rng.uniform_int(n)
                    if not taken[i]:
                        break
                s[k] = E[i].astype(np.int64)
                taken[i] = True
                u[k] = 1
                left -= 1
            else:
                taken[maxi] = True
                s[k] += E[maxi]
                left -= 1
                u[k] += 1
    for k in range(p):
        D[k] = s[k] >= (u[k] // 2)


def initialize_random(E, D, A):
    """bsvd.cpp:385-397 (bernoulli 0.5 per element, row-major order)."""
    rng = _get_rng()
    K, M = D.shape
    for k in range(K):
        for j in range(M):
            D[k, j] = bool(rng.bernoulli(0.5))
    A[:] = 0


# ---------------------------------------------------------------------------
# coefficient update (bsvd.cpp:399-460 / 1029-1107 — same result)
# ---------------------------------------------------------------------------

def update_coefficients(E, D, A):
    n, m = E.shape
    p = D.shape[0]
    Df = D.astype(np.int32)
    wD = Df.sum(axis=1)
    active = np.ones(n, dtype=bool)
    ichanged = np.zeros(n, dtype=bool)
    Ecur = E.copy()
    Acur = A.copy()
    while active.any():
        idx = np.flatnonzero(active)
        Esub = Ecur[idx]
        w = Esub.sum(axis=1)
        # d[i,k] = |Ei| + |Dk| - 2 <Ei, Dk>
        cross = Esub.astype(np.int32) @ Df.T
        d = w[:, None] + wD[None, :] - 2 * cross
        bestk = np.argmin(d, axis=1)           # first min, k ascending
        bestd = d[np.arange(len(idx)), bestk]
        improve = bestd < w
        flip_rows = idx[improve]
        ks = bestk[improve]
        Acur[flip_rows, ks] ^= True
        Ecur[flip_rows] ^= D[ks]
        ichanged[flip_rows] = True
        nxt = np.zeros(n, dtype=bool)
        nxt[flip_rows] = True
        active = nxt
    E[:] = Ecur
    A[:] = Acur
    return int(ichanged.sum())


# ---------------------------------------------------------------------------
# dictionary updates (bsvd.cpp:463-735)
# ---------------------------------------------------------------------------

def update_dictionary_steepest(E, D, A):
    n, m = E.shape
    p = D.shape[0]
    changed = 0
    for k in range(p):
        users = A[:, k]
        usage = int(users.sum())
        if not usage:
            continue
        Dk = D[k].copy()
        weights = (E[users] ^ Dk[None, :]).sum(axis=0)
        u = usage // 2
        newDk = weights > u
        if (newDk ^ Dk).any():
            changed += 1
            D[k] = newDk
            E[users] ^= (Dk ^ newDk)[None, :]
    return changed


def update_dictionary_proximus(E, D, A):
    n, m = E.shape
    p = D.shape[0]
    changed = 0
    for k in range(p):
        kchanged = False
        while True:
            converged = True
            users = A[:, k]
            u = int(users.sum())
            Dk = D[k].copy()
            if u:
                Dw = (E[users] ^ Dk[None, :]).sum(axis=0)
                newDk = Dw > (u // 2)
                if (newDk ^ Dk).any():
                    D[k] = newDk
                    converged = False
                    kchanged = True
                    E[users] ^= (Dk ^ newDk)[None, :]
            Dk = D[k]
            sup = Dk
            us = int(sup.sum())
            Ak = A[:, k].copy()
            if us:
                Aw = (E[:, sup] ^ Ak[:, None]).sum(axis=1)
                newAk = Aw > (us // 2)
                if (newAk ^ Ak).any():
                    A[:, k] = newAk
                    converged = False
                    E[np.ix_((Ak ^ newAk), sup)] ^= True
            if converged:
                break
        if kchanged:
            changed += 1
    return changed


# the _omp variants produce identical results (cu: per-sample independence;
# du proximus_omp is serial code despite its name, bsvd.cpp:822); the racy
# steepest_omp (bsvd.cpp:738-819) is intentionally NOT replicated.
CU_CATALOG = [update_coefficients, update_coefficients,
              None]  # cu 2 ("fast") is marked broken in the reference
DU_CATALOG = [update_dictionary_steepest, update_dictionary_proximus,
              update_dictionary_steepest, update_dictionary_proximus]
MI_CATALOG = [initialize_neighbor, initialize_partition,
              initialize_random_centroids, initialize_random_centroids_xor,
              initialize_graph_grow]


# ---------------------------------------------------------------------------
# learning loops (bsvd.cpp:1215-1434)
# ---------------------------------------------------------------------------

def _mulAD(A, D):
    return (A.astype(np.int64) @ D.astype(np.int64)) % 2 == 1


def learn_traditional(X, E, D, A, cu, du):
    E[:] = _mulAD(A, D) ^ X
    iters = 0
    changed = 1
    while changed > 0:
        iters += 1
        changed = cu(E, D, A) + du(E, D, A)
    return iters


def learn_alter1(X, E, D, A, cu, du):
    E[:] = _mulAD(A, D) ^ X
    iters = 0
    changed = 1
    while changed > 0:
        iters += 1
        changed = cu(E, D, A) + du(E, D, A)
        Et, Dt, At = E.T.copy(), D.T.copy(), A.T.copy()
        cu(Et, At, Dt)
        changed = du(Et, At, Dt)
        E[:], D[:], A[:] = Et.T, Dt.T, At.T
    return iters


def learn_alter2(X, E, D, A, cu, du):
    """bsvd.cpp:1311-1373 — note `changed` is NOT reset before the direct
    phase of later outer passes, so after pass 1 only the transposed phase
    repeats until nothing changes."""
    E[:] = _mulAD(A, D) ^ X
    iters = 0
    changed = 1
    outer = 1
    while outer > 0:
        outer = 0
        while changed > 0:
            iters += 1
            changed = cu(E, D, A) + du(E, D, A)
            outer += changed
        Et, Dt, At = E.T.copy(), D.T.copy(), A.T.copy()
        changed = 1
        while changed > 0:
            changed = cu(Et, At, Dt) + du(Et, At, Dt)
            outer += changed
        E[:], D[:], A[:] = Et.T, Dt.T, At.T
    return iters


def learn_alter3(X, E, D, A, cu, du):
    E[:] = _mulAD(A, D) ^ X
    iters = 0
    changed = 1
    while changed > 0:
        iters += 1
        Et, Dt, At = E.T.copy(), D.T.copy(), A.T.copy()
        changed = du(Et, At, Dt)
        E[:], D[:], A[:] = Et.T, Dt.T, At.T
        changed = du(E, D, A)
    return iters


LM_CATALOG = [learn_traditional, learn_alter1, learn_alter2, learn_alter3]


def run_bsvd_test(img: np.ndarray, W: int = 16, K: int = 512,
                  image_mode: bool = False, mi: int = 0, cu: int = 0,
                  du: int = 0, lm: int = 0, seed: int = 34503498):
    """bsvd_test.cpp main flow; returns (D, A, E, final_E_weight,
    residual_image_or_None)."""
    reset_rng(seed)
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    if image_mode:
        ny, nx = -(-rows // W), -(-cols // W)
        M = W * W
        N = ny * nx
        grid = np.zeros((ny * W, nx * W), dtype=bool)
        grid[:rows, :cols] = img
        X = grid.reshape(ny, W, nx, W).swapaxes(1, 2).reshape(N, M)
    else:
        X = img.copy()
        N, M = X.shape
    D = np.zeros((K, M), dtype=bool)
    A = np.zeros((N, K), dtype=bool)
    cu_fn = CU_CATALOG[cu]
    du_fn = DU_CATALOG[du]
    MI_CATALOG[mi](X, D, A)
    E = np.zeros((N, M), dtype=bool)
    LM_CATALOG[lm](X, E, D, A, cu_fn, du_fn)
    res_img = None
    if image_mode:
        out = np.asarray(img, dtype=bool).copy()
        ny, nx = -(-rows // W), -(-cols // W)
        li = 0
        for i in range(ny):
            for j in range(nx):
                tile = E[li].reshape(W, W)
                i1 = min(rows, i * W + W)
                j1 = min(cols, j * W + W)
                out[i * W:i1, j * W:j1] = tile[: i1 - i * W, : j1 - j * W]
                li += 1
        res_img = out
    final_E = _mulAD(A, D) ^ X
    return D, A, E, int(final_E.sum()), res_img


# ---------------------------------------------------------------------------
# MDL model selection (bsvd.cpp:1438-1717)
# ---------------------------------------------------------------------------

def _c_ulong(x: float) -> int:
    import math
    if math.isnan(x) or math.isinf(x) or x >= 2.0 ** 64 or x <= -2.0 ** 63:
        return 1 << 63
    return int(x) & ((1 << 64) - 1)


def model_codelength(E, D, A) -> int:
    """bsvd.cpp:1438-1461: idx_t accumulation (per-term truncation)."""
    from ..ops.entropy import universal_codelength as ucl
    N, M = E.shape
    K = D.shape[0]
    LE = _c_ulong(ucl(N * M, int(E.sum())))
    LD = 0
    LA = 0
    for k in range(K):
        LD = _c_ulong(LD + ucl(M, int(D[k].sum())))
        LA = _c_ulong(LA + ucl(N, int(A[:, k].sum())))
    return (LE + LD + LA) & ((1 << 64) - 1)


def run_mdl(img, W=8, K0=8, image_mode=True, mi=0, cu=0, du=0, lmi=0,
            direction="forward", seed=34503498, max_steps=None,
            stuck_limit=10):
    """learn_model_mdl_{forward,backward}_selection (bsvd.cpp:1463-1663).

    max_steps bounds the K sweep for testing; None = reference behaviour
    (run until the stuck counter hits 10)."""
    reset_rng(seed)
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    if image_mode:
        ny, nx = -(-rows // W), -(-cols // W)
        M = W * W
        N = ny * nx
        grid = np.zeros((ny * W, nx * W), dtype=bool)
        grid[:rows, :cols] = img
        X = grid.reshape(ny, W, nx, W).swapaxes(1, 2).reshape(N, M)
    else:
        X = img.copy()
        N, M = X.shape
    cu_fn = CU_CATALOG[cu]
    du_fn = DU_CATALOG[du]
    lm_fn = LM_CATALOG[lmi]
    U64_ = (1 << 64) - 1

    D = np.zeros((K0, M), dtype=bool)
    A = np.zeros((N, K0), dtype=bool)
    MI_CATALOG[mi](X, D, A)
    E = np.zeros((N, M), dtype=bool)
    lm_fn(X, E, D, A, cu_fn, du_fn)
    bestL = model_codelength(E, D, A)
    bestK = K0
    stuck = sum_stuck = all_stuck = 0
    steps = 0

    if direction == "forward":
        currD, currA, currE = D.copy(), A.copy(), E.copy()
        K = K0
        while stuck < stuck_limit:
            currL = model_codelength(currE, currD, currA)
            dev = (sum_stuck // all_stuck) if all_stuck > 0 else 0
            next_atom = np.zeros((1, M), dtype=bool)
            next_coefs = np.zeros((N, 1), dtype=bool)
            MI_CATALOG[mi](currE, next_atom, next_coefs)
            currD = np.vstack([currD, next_atom])
            currA = np.hstack([currA, next_coefs])
            lm_fn(X, currE, currD, currA, cu_fn, du_fn)
            currL = model_codelength(currE, currD, currA)
            if ((currL + dev) & U64_) < bestL:
                stuck = 0
                bestL = currL
                D, A, E = currD.copy(), currA.copy(), currE.copy()
                bestK = K + 1
            else:
                stuck += 1
                all_stuck += 1
                sum_stuck = (sum_stuck + currL - bestL) & U64_
                if stuck >= stuck_limit:
                    break
            K += 1
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
    else:  # backward
        from ..ops.entropy import universal_codelength as ucl
        currD, currA = D.copy(), A.copy()
        currL = bestL
        K = K0
        while K > 0:
            dev = (sum_stuck // all_stuck) if all_stuck > 0 else 0
            nextk = 0
            nextL = None
            for k in range(K):
                Dk = currD[k]
                Ak = currA[:, k]
                AkDk = np.outer(Ak, Dk)
                nextE = AkDk ^ E
                tmpL = model_codelength(nextE, currD, currA)
                tmpL = _c_ulong(tmpL - ucl(M, int(Dk.sum())))
                tmpL = _c_ulong(tmpL - ucl(N, int(Ak.sum())))
                if nextL is None or tmpL < nextL:
                    nextL = tmpL
                    nextk = k
            if K > 1:
                keep = [k for k in range(K) if k != nextk]
                nextD = currD[keep]
                nextA = currA[:, keep]
                nextE = np.zeros((N, M), dtype=bool)
                lm_fn(X, nextE, nextD, nextA, cu_fn, du_fn)
                nextL = model_codelength(nextE, nextD, nextA)
            else:
                nextD = np.zeros((0, M), dtype=bool)
                nextA = np.zeros((N, 0), dtype=bool)
                nextE = np.outer(currA[:, 0], currD[0]) ^ E
                nextL = model_codelength(nextE, nextD, nextA)
            if ((nextL + dev) & U64_) < bestL:
                if K == 1:
                    D, A = nextD, nextA
                    E = X.copy()
                    break
                stuck = 0
                bestK = K - 1
                bestL = nextL
                D, A, E = nextD.copy(), nextA.copy(), nextE.copy()
            else:
                stuck += 1
                all_stuck += 1
                sum_stuck = (sum_stuck + nextL - bestL) & U64_
                if stuck >= stuck_limit:
                    break
            currD, currA = nextD, nextA
            currL = nextL
            K -= 1
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
    return {"D": D, "A": A, "E": E, "bestK": bestK, "bestL": int(bestL)}


def run_mdl_full_search(img, W=8, Kmax=40, Kstep=20, reps=10,
                        image_mode=True, mi=0, cu=0, du=0, lmi=0,
                        seed=34503498):
    """learn_model_mdl_full_search (bsvd.cpp:1665-1717): sweep K in steps,
    REPS random restarts each (the reference 'reseeds' a global the RNG
    singleton never re-reads — the stream just continues, bsvd.cpp:1686),
    keep the best MDL."""
    reset_rng(seed)
    img = np.asarray(img, dtype=bool)
    rows, cols = img.shape
    if image_mode:
        ny, nx = -(-rows // W), -(-cols // W)
        M = W * W
        N = ny * nx
        grid = np.zeros((ny * W, nx * W), dtype=bool)
        grid[:rows, :cols] = img
        X = grid.reshape(ny, W, nx, W).swapaxes(1, 2).reshape(N, M)
    else:
        X = img.copy()
        N, M = X.shape
    cu_fn, du_fn, lm_fn = CU_CATALOG[cu], DU_CATALOG[du], LM_CATALOG[lmi]
    bestL = 1 << 30
    best = None
    for k in range(Kstep, Kmax + 1, Kstep):
        candD = np.zeros((k, M), dtype=bool)
        candA = np.zeros((N, k), dtype=bool)
        candE = np.zeros((N, M), dtype=bool)
        MI_CATALOG[mi](X, candD, candA)
        lm_fn(X, candE, candD, candA, cu_fn, du_fn)
        cand_best = None
        for _ in range(reps):
            MI_CATALOG[mi](X, candD, candA)
            lm_fn(X, candE, candD, candA, cu_fn, du_fn)
            L = model_codelength(candE, candD, candA)
            if cand_best is None or L < cand_best:
                cand_best = L
                snap = (candD.copy(), candA.copy(), candE.copy())
        if cand_best < bestL:
            bestL = cand_best
            best = (k,) + snap
    k, D, A, E = best
    return {"D": D, "A": A, "E": E, "bestK": k, "bestL": int(bestL)}
