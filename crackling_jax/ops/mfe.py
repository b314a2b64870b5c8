"""Batched RNA minimum-free-energy folding (Zuker-style DP) in JAX.

In-process replacement for the reference's RNAfold subprocess call
(/root/reference/src/crackling/Crackling.py:426-433). The pipeline folds the
fixed-length 100-nt construct ``'G' + spacer[1:20] + scaffold`` — a fixed
shape, so the whole O(n^3) dynamic program compiles once and runs batched
over guides on the default JAX device.

Energy model: ops/rna_params.py (shared with the native C++ engine,
native/fold.cpp) — Turner-2004-style stacking, loop initiations with Ninio
asymmetry, terminal mismatches, d2-style dangles on multiloop/exterior
stems, special tetraloop bonuses. The two engines agree on the model
bit-for-bit; cross-engine agreement is tested in tests/test_mfe.py.

Structure of the kernel: everything that depends only on the sequence
(pair codes, hairpin energies, mismatch/stem weights) is precomputed as
dense (B, n, n) host matrices; the jitted DP is a ``fori_loop`` over
columns whose body is a handful of vector ops plus one (31, 31) window
gather for the interior-loop transition — no Python-level unrolling, so
compilation is seconds, not minutes, and the work is fully vectorized
over (batch, i).

Traceback (dot-bracket) runs on host from the device-computed tables — it
is O(n) sequential per guide and data-dependent, the one part of the
algorithm that does not vectorize. The pipeline's default fold
backend is the native C++ engine, which does its own traceback.
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils.x64 import enable_x64
from . import rna_params as rp

INF = rp.INF
MAXLOOP = rp.MAXLOOP


def encode_rna(seq: str) -> np.ndarray:
    """RNA/DNA string -> codes (A=0, C=1, G=2, U/T=3)."""
    table = np.full(256, 255, dtype=np.uint8)
    for ch, c in zip("ACGUacgu", [0, 1, 2, 3, 0, 1, 2, 3]):
        table[ord(ch)] = c
    table[ord("T")] = 3
    table[ord("t")] = 3
    codes = table[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if (codes == 255).any():
        raise ValueError(f"non-ACGU character in RNA sequence: {seq!r}")
    return codes


def _precompute(codes: np.ndarray):
    """Sequence-dependent dense matrices for the DP (host numpy, float64).

    Returns dict with (B, n, n) matrices:
      hp        full hairpin energy for closing pair (i, j)
      mi_out    outer interior-loop mismatch for closing pair (i, j)
      mi_in     inner interior-loop mismatch for inner pair (k, l)
      mlw       multiloop stem weight for stem (k, l)  (excl. V)
      extw      exterior stem weight for stem (k, j)   (excl. V)
      mlclose   multiloop closing-pair contribution for (i, j)
      stack2    stack[pc(i,j), pc(i+1,j-1)] style pairwise table is folded
                into the DP via pc; pc itself is returned too.
    """
    t = rp.tables(512)
    B, n = codes.shape
    pc = rp.PAIR_CODE[codes[:, :, None], codes[:, None, :]]
    pc = np.where(pc < 0, 6, pc).astype(np.int32)          # (B, n, n)
    can_pair = pc != 6

    i_idx = np.arange(n)
    au = rp.PAIR_IS_AU[pc] * rp.TERMINAL_AU                 # (B, n, n)

    # neighbors clipped to stay in range; boundary handling below
    nxt = np.minimum(i_idx + 1, n - 1)
    prv = np.maximum(i_idx - 1, 0)
    s_ip1 = codes[:, nxt]          # s[i+1]
    s_im1 = codes[:, prv]          # s[i-1]

    # hairpin: init + (triloop: AU | >3: mismatch); a special tri/tetra/
    # hexaloop entry is a TOTAL energy replacing the generic formula
    # (ViennaRNA E_Hairpin semantics; INF in the table means no entry)
    ls = i_idx[None, :] - i_idx[:, None] - 1                # (n, n) j - i - 1
    ls_b = np.broadcast_to(ls, (B, n, n))
    hp = t["hairpin"][np.clip(ls_b, 0, 512)].copy()
    mm_h = t["mismatch_h"][pc, s_ip1[:, :, None], s_im1[:, None, :]]
    hp += np.where(ls_b == 3, au, mm_h)
    # special loops: packed subsequence codes
    for L, key in ((3, "tri"), (4, "tetra"), (6, "hexa")):
        tbl = t[key]
        if not (tbl < INF / 2).any():
            continue
        W = L + 2
        if n < W:
            continue
        packs = np.zeros((B, n - W + 1), dtype=np.int64)
        for m in range(W):
            packs = packs * 4 + codes[:, m:n - W + 1 + m]
        total = tbl[packs]                                  # (B, n-W+1)
        ii = np.arange(n - W + 1)
        sub = hp[:, ii, ii + W - 1]
        hp[:, ii, ii + W - 1] = np.where(total < INF / 2, total, sub)
    hp = np.where((ls_b >= 3) & can_pair, hp, INF)

    # interior-loop mismatches (generic, 1xn, and 2x3 families)
    pc_rev = rp.PAIR_REV[pc]

    def mi_pair(key):
        out = t[key][pc, s_ip1[:, :, None], s_im1[:, None, :]]
        # inner pair (k, l): tbl[rev(pc[k,l]), s[l+1], s[k-1]]
        inn = t[key][pc_rev, s_ip1[:, None, :], s_im1[:, :, None]]
        return out, inn

    mi_out, mi_in = mi_pair("mismatch_i")
    mi1n_out, mi1n_in = mi_pair("mismatch_1n")
    mi23_out, mi23_in = mi_pair("mismatch_23")

    # special small interior loops: complete transition energies (i,j) ->
    # implied inner pair, ViennaRNA int11/int21/int22 conventions; INF
    # where the inner pair is off-grid or unpairable
    def shift(k):
        return codes[:, np.clip(i_idx + k, 0, n - 1)]

    s1, s2 = shift(1), shift(2)
    sm1, sm2 = shift(-1), shift(-2)
    pin = {(dk, dl): np.where(
        (i_idx[:, None] + dk < n) & (i_idx[None, :] - dl >= 0),
        pc_rev[:, np.clip(i_idx + dk, 0, n - 1)[:, None],
               np.clip(i_idx - dl, 0, n - 1)[None, :]], 6)
        for dk, dl in ((2, 2), (2, 3), (3, 2), (3, 3))}
    e11 = t["int11"][pc, pin[(2, 2)], s1[:, :, None], sm1[:, None, :]]
    e12 = t["int21"][pc, pin[(2, 3)], s1[:, :, None],
                     sm2[:, None, :], sm1[:, None, :]]
    e21 = t["int21"][pin[(3, 2)], pc, sm1[:, None, :],
                     s1[:, :, None], s2[:, :, None]]
    e22 = t["int22"][pc, pin[(3, 3)], s1[:, :, None], s2[:, :, None],
                     sm2[:, None, :], sm1[:, None, :]]

    # d2 stem weights (boundary-aware): stem (k, l) gets
    # mm[pc, s[k-1], s[l+1]] inside, or single dangles at the boundary
    def stem_weight(mm_tbl):
        both = mm_tbl[pc, s_im1[:, :, None], s_ip1[:, None, :]]
        d5 = t["dangle5"][pc, s_im1[:, :, None]]
        d3 = t["dangle3"][pc, s_ip1[:, None, :]]
        k_is0 = (i_idx == 0)[None, :, None]
        l_isn = (i_idx == n - 1)[None, None, :]
        w = np.where(k_is0 & l_isn, 0.0,
                     np.where(k_is0, d3,
                              np.where(l_isn, d5, both)))
        return w + au

    mlw = stem_weight(t["mismatch_m"]) + rp.ML_INTERN
    extw = stem_weight(t["mismatch_e"])

    # multiloop closing pair (i, j): reversed pair, si1 = s[j-1], sj1 = s[i+1]
    mlclose = (rp.ML_CLOSE + rp.ML_INTERN + au
               + t["mismatch_m"][pc_rev, s_im1[:, None, :], s_ip1[:, :, None]])

    return dict(pc=pc, can_pair=can_pair, hp=hp, mi_out=mi_out, mi_in=mi_in,
                mi1n_out=mi1n_out, mi1n_in=mi1n_in,
                mi23_out=mi23_out, mi23_in=mi23_in,
                e11=e11, e12=e12, e21=e21, e22=e22,
                mlw=mlw, extw=extw, mlclose=mlclose,
                stack=t["stack"], bulge=t["bulge"], internal=t["internal"])


def _loop_grids():
    """Static interior-loop initiation grids.

    Returns ``(grid, c1n, c23)``: the generic (L-1, L-1) init+Ninio grid
    for a,b in 1..L-1 with INF at every cell handled by a dedicated path
    (a==1 or b==1 rows/cols, and the 2x2 / 2x3 / 3x2 cells); the 1xn
    init+Ninio vector over n = 3..L-1; and the 2x3 init+Ninio scalar."""
    t = rp.tables(512)
    L = MAXLOOP
    a = np.arange(1, L)[:, None]
    b = np.arange(1, L)[None, :]
    special = ((a == 1) | (b == 1)
               | ((a == 2) & (b == 2)) | ((a == 2) & (b == 3))
               | ((a == 3) & (b == 2)))
    grid = np.where(
        (a + b <= L) & ~special,
        t["internal"][np.clip(a + b, 0, 512)]
        + np.minimum(rp.NINIO_MAX, rp.NINIO * np.abs(a - b)),
        INF,
    )
    ns = np.arange(3, L)
    c1n = (t["internal"][1 + ns]
           + np.minimum(rp.NINIO_MAX, rp.NINIO * (ns - 1)))
    c23 = float(t["internal"][5] + min(rp.NINIO_MAX, rp.NINIO))
    return grid, c1n, c23


def fold_batch(codes: np.ndarray):
    """MFE-fold a batch of equal-length RNA code arrays.

    Parameters: ``codes`` (B, n) uint8. Returns ``(energy (B,), tables)``
    where ``tables`` is the dict of DP tables (host numpy) used by
    :func:`traceback`. The DP runs in f64 on the default device, as
    native/fold.cpp computes: in f32, rounding can break an equal-energy
    tie the other way in the traceback.
    """
    codes = np.asarray(codes)
    B, n = codes.shape
    pre = _precompute(codes)
    with enable_x64():
        V, fML, fM1, f5 = _fold_device(pre, B, n)
    tables = {"eps": 1e-6, "V": V, "fML": fML, "fM1": fM1, "f5": f5,
              "pre": pre}
    energy = np.minimum(tables["f5"][:, n - 1], 0.0)
    return energy, tables


def _fold_device(pre: dict, B: int, n: int):
    """The jitted DP over the precomputed tables, in f64 (x64 on);
    returns the host (V, fML, fM1, f5) tables."""
    import jax.numpy as jnp

    grid, c1n, c23 = _loop_grids()
    L = MAXLOOP
    bulge_t = pre["bulge"][: L + 1].copy()     # (31,)
    stack_t = pre["stack"]

    def cast(x):
        return jnp.asarray(np.asarray(x), dtype=jnp.float64)

    hp_j = cast(pre["hp"])
    mi_out_j = cast(pre["mi_out"])
    mi_in_j = cast(pre["mi_in"])
    mlw_j = cast(pre["mlw"])
    extw_j = cast(pre["extw"])
    mlclose_j = cast(pre["mlclose"])
    grid_j = cast(grid)
    bulge_j = cast(bulge_t)
    stack_j = cast(stack_t)
    au_out = cast(rp.PAIR_IS_AU[pre["pc"]] * rp.TERMINAL_AU)
    pc_j = jnp.asarray(pre["pc"])
    can_j = jnp.asarray(pre["can_pair"])
    spec_j = [cast(pre[k]) for k in ("e11", "e12", "e21", "e22")]
    mi1n_j = [cast(pre[k]) for k in ("mi1n_out", "mi1n_in")]
    mi23_j = [cast(pre[k]) for k in ("mi23_out", "mi23_in")]
    c1n_j = cast(c1n)

    run = _fold_run(B, n, float(c23), float(rp.ML_BASE))
    out = run(hp_j, mi_out_j, mi_in_j, mlw_j, extw_j, mlclose_j, au_out,
              pc_j, can_j, stack_j, bulge_j, grid_j,
              *spec_j, *mi1n_j, *mi23_j, c1n_j)
    return tuple(np.asarray(x, dtype=np.float64) for x in out)


@functools.lru_cache(maxsize=8)
def _fold_run(B: int, n: int, c23: float, ml_base: float):
    """Shape-cached jitted DP core.

    ``fold_batch`` used to define this under a fresh ``jax.jit`` per
    call, re-tracing and recompiling the whole fold for every batch; the
    cache makes repeat page folds of the pipeline pay tracing once per
    (batch, length) shape. Every device table is a jit *argument* —
    closure-captured device arrays are fetched back to the host at
    lowering to embed as MLIR constants — and the index vectors are
    numpy, which embeds from the host for free.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    dtype = jnp.float64
    L = MAXLOOP
    iidx = np.arange(n)
    a_in = np.arange(1, L)                     # interior a (29,)
    b_in = np.arange(1, L)
    a_bul = np.arange(0, L + 1)                # bulge sizes (31,)
    n_1n = np.arange(3, L)                     # 1xn long-side sizes (27,)

    @jax.jit
    def run(hp_j, mi_out_j, mi_in_j, mlw_j, extw_j, mlclose_j, au_out,
            pc_j, can_j, stack_j, bulge_j, grid_j,
            e11_j, e12_j, e21_j, e22_j,
            mi1n_out_j, mi1n_in_j, mi23_out_j, mi23_in_j, c1n_j):
        INFD = jnp.asarray(INF, dtype)

        V0 = jnp.full((B, n, n), INFD, dtype=dtype)
        W0 = V0 + mi_in_j                       # V + inner mismatch
        Vau0 = V0                               # V + inner AU (for bulges)
        fML0 = jnp.full((B, n, n), INFD, dtype=dtype)
        fM10 = jnp.full((B, n, n), INFD, dtype=dtype)

        def clipg(x):
            return jnp.clip(x, 0, n - 1)

        def col(j, state):
            V, W, Vau, fML, fM1 = state
            # ----- V(i, j) -----
            v_new = hp_j[:, :, j]
            # stack (a=0, b=0)
            kk0 = clipg(iidx + 1)
            ll0 = clipg(j - 1)
            p1 = pc_j[:, :, j]
            p2 = pc_j[:, kk0, ll0]
            st = stack_j[p1, p2] + V[:, kk0, ll0]
            st = jnp.where((iidx + 1 < j - 1), st, INFD)
            v_new = jnp.minimum(v_new, st)
            # bulges: a = 0, b >= 1  (inner pair (i+1, j-1-b))
            bsz = a_bul[1:]                                    # (30,)
            llb = clipg(j - 1 - bsz)
            p2b = pc_j[:, kk0[:, None], llb[None, :]]          # (B, n, 30)
            innb = V[:, kk0[:, None], llb[None, :]]
            vaub = Vau[:, kk0[:, None], llb[None, :]]
            size1 = stack_j[p1[:, :, None], p2b] + bulge_j[1] + innb
            sizeg = (bulge_j[bsz][None, None, :]
                     + au_out[:, :, j][:, :, None] + vaub)
            eb = jnp.where((bsz == 1)[None, None, :], size1, sizeg)
            valid_b = (iidx[None, :, None] + 1) < (j - 1 - bsz)[None, None, :]
            v_new = jnp.minimum(v_new, jnp.min(
                jnp.where(valid_b, eb, INFD), axis=2))
            # bulges: b = 0, a >= 1 (inner pair (i+1+a, j-1))
            kka = clipg(iidx[:, None] + 1 + bsz[None, :])      # (n, 30)
            p2a = pc_j[:, kka, ll0]
            inna = V[:, kka, ll0]
            vaua = Vau[:, kka, ll0]
            size1a = stack_j[p1[:, :, None], p2a] + bulge_j[1] + inna
            sizega = (bulge_j[bsz][None, None, :]
                      + au_out[:, :, j][:, :, None] + vaua)
            ea = jnp.where((bsz == 1)[None, None, :], size1a, sizega)
            valid_a = (iidx[:, None] + 1 + bsz[None, :])[None] < (j - 1)
            v_new = jnp.minimum(v_new, jnp.min(
                jnp.where(valid_a, ea, INFD), axis=2))
            # generic interior loops via the W window gather (cells with a
            # dedicated ViennaRNA path are INF in grid_j and handled below)
            kki = clipg(iidx[:, None] + 1 + a_in[None, :])     # (n, 29)
            lli = clipg(j - 1 - b_in)                          # (29,)
            win = W[:, kki[:, :, None], lli[None, None, :]]
            # (B, n, 29, 29)
            cand = grid_j[None, None] + win
            valid_i = kki[:, :, None] < (j - 1 - b_in)[None, None, :]
            cand = jnp.where(valid_i[None], cand, INFD)
            v_new = jnp.minimum(
                v_new, mi_out_j[:, :, j] + jnp.min(cand, axis=(2, 3)))
            # 1x1 / 1x2 / 2x1 / 2x2 interior loops: dedicated tables; the
            # precomputed E matrices are the complete transition energy
            kk2 = clipg(iidx + 2)
            kk3 = clipg(iidx + 3)
            kk4 = clipg(iidx + 4)
            jm2, jm3, jm4 = clipg(j - 2), clipg(j - 3), clipg(j - 4)

            def spec(E, kk, ll, dk, dl):
                ok = (iidx + dk) < (j - dl)
                return jnp.where(ok, E[:, :, j] + V[:, kk, ll], INFD)

            v_new = jnp.minimum(v_new, spec(e11_j, kk2, jm2, 2, 2))
            v_new = jnp.minimum(v_new, spec(e12_j, kk2, jm3, 2, 3))
            v_new = jnp.minimum(v_new, spec(e21_j, kk3, jm2, 3, 2))
            v_new = jnp.minimum(v_new, spec(e22_j, kk3, jm3, 3, 3))
            # 2x3 / 3x2: dedicated mismatch family, fixed inner offsets
            e23 = (c23 + mi23_out_j[:, :, j]
                   + mi23_in_j[:, kk3, jm4] + V[:, kk3, jm4])
            v_new = jnp.minimum(
                v_new, jnp.where((iidx + 3) < (j - 4), e23, INFD))
            e32 = (c23 + mi23_out_j[:, :, j]
                   + mi23_in_j[:, kk4, jm3] + V[:, kk4, jm3])
            v_new = jnp.minimum(
                v_new, jnp.where((iidx + 4) < (j - 3), e32, INFD))
            # 1xn (n >= 3): inner (i+2, j-1-n), 1n mismatch family
            ll1 = clipg(j - 1 - n_1n)                          # (27,)
            w1 = (V[:, kk2[:, None], ll1[None, :]]
                  + mi1n_in_j[:, kk2[:, None], ll1[None, :]])
            ok1 = (iidx + 2)[:, None] < (j - 1 - n_1n)[None, :]
            cand1 = jnp.where(ok1[None], c1n_j[None, None] + w1, INFD)
            v_new = jnp.minimum(
                v_new, mi1n_out_j[:, :, j] + jnp.min(cand1, axis=2))
            # nx1 (n >= 3): inner (i+1+n, j-2)
            kkn = clipg(iidx[:, None] + 1 + n_1n[None, :])     # (n, 27)
            wn = V[:, kkn, jm2] + mi1n_in_j[:, kkn, jm2]
            okn = (iidx[:, None] + 1 + n_1n[None, :]) < (j - 2)
            candn = jnp.where(okn[None], c1n_j[None, None] + wn, INFD)
            v_new = jnp.minimum(
                v_new, mi1n_out_j[:, :, j] + jnp.min(candn, axis=2))
            # multiloop closure
            fm1_col = fM1[:, :, clipg(j - 1)]                  # (B, n) over k
            # fML(i+1, k-1): shift rows i -> i+1, then cols k -> k-1
            fml_shift = jnp.concatenate(
                [fML[:, 1:, :], jnp.full((B, 1, n), INFD, dtype)], axis=1)
            fml_ik = jnp.concatenate(
                [jnp.full((B, n, 1), INFD, dtype), fml_shift[:, :, :-1]],
                axis=2)                                        # [b, i, k]
            ml_min = jnp.min(fml_ik + fm1_col[:, None, :], axis=2)
            v_new = jnp.minimum(v_new, mlclose_j[:, :, j] + ml_min)

            v_new = jnp.where(can_j[:, :, j] & (iidx[None, :] < j),
                              v_new, INFD)
            V = V.at[:, :, j].set(v_new)
            W = W.at[:, :, j].set(v_new + mi_in_j[:, :, j])
            Vau = Vau.at[:, :, j].set(
                v_new + au_out[:, :, j])  # inner AU == outer AU of same pair

            # ----- fM1(i, j) -----
            fm1_new = jnp.minimum(
                fM1[:, :, clipg(j - 1)] + ml_base,
                v_new + mlw_j[:, :, j],
            )
            fM1 = fM1.at[:, :, j].set(fm1_new)

            # ----- fML(i, j) -----
            fml_new = jnp.minimum(
                fML[:, :, clipg(j - 1)] + ml_base, fm1_new)
            fml_ik2 = jnp.concatenate(
                [jnp.full((B, n, 1), INFD, dtype), fML[:, :, :-1]], axis=2)
            two = jnp.min(fml_ik2 + fm1_new[:, None, :], axis=2)
            fml_new = jnp.minimum(fml_new, two)
            # left-unpaired: fML(i,j) <- fML(i+1,j) + ml_base, i.e.
            # min over k >= i of fML(k,j) + (k-i)*ml_base. Rebase by
            # +i*ml_base, reverse-cummin, rebase back (the bias terms
            # cancel exactly when ml_base == 0, the Turner-2004 default).
            ibias = ml_base * iidx.astype(dtype)
            fml_new = jnp.flip(
                lax.associative_scan(jnp.minimum,
                                     jnp.flip(fml_new + ibias[None, :], 1),
                                     axis=1), 1) - ibias[None, :]
            fML = fML.at[:, :, j].set(fml_new)
            return V, W, Vau, fML, fM1

        V, W, Vau, fML, fM1 = lax.fori_loop(
            1, n, col, (V0, W0, Vau0, fML0, fM10))

        # exterior loop
        Vext = V + extw_j

        def ext(j, f5):
            prev = f5[:, j - 1]
            vk = Vext[:, :, j]
            f5k = jnp.concatenate(
                [jnp.zeros((B, 1), dtype), f5[:, :-1]], axis=1)
            best = jnp.min(f5k + vk, axis=1)
            return f5.at[:, j].set(jnp.minimum(prev, best))

        f5 = jnp.zeros((B, n), dtype=dtype)
        f5 = lax.fori_loop(1, n, ext, f5)
        return V, fML, fM1, f5

    return run


def traceback(tables, b: int) -> str:
    """Host traceback of one structure from the DP tables (same model as
    the DP; EPS-tolerant comparisons absorb f32 rounding)."""
    V = tables["V"][b]
    fML = tables["fML"][b]
    fM1 = tables["fM1"][b]
    f5 = tables["f5"][b]
    pre = tables["pre"]
    hp = pre["hp"][b]
    mi_out = pre["mi_out"][b]
    mi_in = pre["mi_in"][b]
    mlw = pre["mlw"][b]
    extw = pre["extw"][b]
    mlclose = pre["mlclose"][b]
    pc = pre["pc"][b]
    au = rp.PAIR_IS_AU[pc] * rp.TERMINAL_AU
    stack_t = pre["stack"]
    bulge_t = pre["bulge"]
    internal_t = pre["internal"]
    e11, e12 = pre["e11"][b], pre["e12"][b]
    e21, e22 = pre["e21"][b], pre["e22"][b]
    mi1n_out, mi1n_in = pre["mi1n_out"][b], pre["mi1n_in"][b]
    mi23_out, mi23_in = pre["mi23_out"][b], pre["mi23_in"][b]
    n = V.shape[0]
    L = MAXLOOP
    out = ["." for _ in range(n)]
    # f64 tables allow exact-tie matching (same tolerance as the C++
    # engine, so co-optimal ties break identically); f32 needs slack
    EPS = tables.get("eps", 1e-2)

    def loop_cost(i, j, k, l):
        # mirrors native/fold.cpp loop_e (ViennaRNA E_IntLoop)
        a, bb = k - i - 1, j - l - 1
        size = a + bb
        if size == 0:
            return stack_t[pc[i, j], pc[k, l]]
        if a == 0 or bb == 0:
            if size == 1:
                return stack_t[pc[i, j], pc[k, l]] + bulge_t[1]
            return bulge_t[size] + au[i, j] + au[k, l]
        if (a, bb) == (1, 1):
            return e11[i, j]
        if (a, bb) == (1, 2):
            return e12[i, j]
        if (a, bb) == (2, 1):
            return e21[i, j]
        if (a, bb) == (2, 2):
            return e22[i, j]
        ninio = min(rp.NINIO_MAX, rp.NINIO * abs(a - bb))
        if a == 1 or bb == 1:
            return (internal_t[size] + ninio
                    + mi1n_out[i, j] + mi1n_in[k, l])
        if size == 5:
            return (internal_t[5] + ninio
                    + mi23_out[i, j] + mi23_in[k, l])
        return internal_t[size] + ninio + mi_out[i, j] + mi_in[k, l]

    def trace_v(i, j):
        out[i] = "("
        out[j] = ")"
        e = V[i, j]
        if abs(e - hp[i, j]) < EPS:
            return
        # candidate order matches native/fold.cpp (k ascending, l
        # descending) so co-optimal ties break identically across engines
        for k in range(i + 1, min(j - 1, i + 2 + L)):
            for l in range(j - 1, max(k + 1, j - 1 - (L - (k - i - 1))) - 1, -1):
                if pc[k, l] == 6:
                    continue
                if abs(e - (loop_cost(i, j, k, l) + V[k, l])) < EPS:
                    trace_v(k, l)
                    return
        for k in range(i + 2, j):
            if abs(e - (mlclose[i, j] + fML[i + 1, k - 1]
                        + fM1[k, j - 1])) < EPS:
                trace_fml(i + 1, k - 1)
                trace_fm1(k, j - 1)
                return

    def trace_fm1(i, j):
        while j > i and abs(fM1[i, j] - (fM1[i, j - 1] + rp.ML_BASE)) < EPS:
            j -= 1
        trace_v(i, j)

    def trace_fml(i, j):
        while True:
            if abs(fML[i, j] - fM1[i, j]) < EPS:
                trace_fm1(i, j)
                return
            if i < j and abs(fML[i, j] - (fML[i + 1, j] + rp.ML_BASE)) < EPS:
                i += 1
                continue
            if j > i and abs(fML[i, j] - (fML[i, j - 1] + rp.ML_BASE)) < EPS:
                j -= 1
                continue
            done = False
            for k in range(i + 1, j + 1):
                if abs(fML[i, j] - (fML[i, k - 1] + fM1[k, j])) < EPS:
                    trace_fm1(k, j)
                    j = k - 1
                    done = True
                    break
            if not done:
                return

    def trace_f5(j):
        while j > 0:
            if abs(f5[j] - f5[j - 1]) < EPS:
                j -= 1
                continue
            found = False
            for k in range(0, j - 3):
                prev = f5[k - 1] if k >= 1 else 0.0
                if abs(f5[j] - (prev + V[k, j] + extw[k, j])) < EPS:
                    trace_v(k, j)
                    j = k - 1
                    found = True
                    break
            if not found:
                return

    if f5[n - 1] < INF / 2 and f5[n - 1] < -EPS:
        trace_f5(n - 1)
    return "".join(out)


def fold_sequences(seqs: list[str]):
    """Fold a list of equal-length RNA strings with the JAX engine.

    Returns (structures, energies) where structures are dot-bracket strings
    and energies are floats (kcal/mol, 0.0 for a fully unpaired strand).
    """
    if not seqs:
        return [], np.zeros(0)
    codes = np.stack([encode_rna(s) for s in seqs])
    energy, tables = fold_batch(codes)
    structures = [traceback(tables, b) for b in range(len(seqs))]
    return structures, energy
