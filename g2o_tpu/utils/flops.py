"""Analytic FLOP model for MFU reporting.

Counts the ALGORITHMIC floating-point work of an LM optimization — the
multiply-adds mathematically required by the formulas (residual/Jacobian
production, H/b assembly, CG matvecs, preconditioner builds/applies) — not
the FLOPs XLA happens to execute (one-hot index matmuls, padding, masking
and relayout work are deliberately excluded; they are overhead, not useful
work).  MFU numbers derived from this model are therefore conservative
lower bounds on hardware utilization.

The model mirrors the reference's own cost accounting axes
(``g2o/core/batch_stats.h:47-71``: residuals / quadratic form / linear
solve), using the measured per-iteration CG and λ-trial counts that
``optimize_fused`` returns (``cg_per_iteration``, ``trials_per_iteration``).

Peaks come from one table keyed by ``device_kind`` (NVIDIA's H100 SXM data
sheet, dense rates at the full 700 W power limit): 495 TFLOP/s TF32 on the
tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM.  A device
that is not in the table is an error, not a default.  MFU is reported
against both f32 rates: an f32 matmul at DEFAULT precision runs TF32 on the
tensor cores, one at HIGHEST runs full f32, and this workload mixes both.
A card set below 700 W (``nvidia-smi`` ``power.limit``) cannot hold these
rates; the benchmark prints the limit beside every MFU.
"""

from __future__ import annotations

# device_kind substring (lower case) -> peak rates
_PEAKS = {
    "h100": {"tf32_flops_per_s": 495e12,
             "f32_flops_per_s": 67e12,
             "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device=None) -> dict:
    """Peak rates of ``device`` (default: the first JAX device).
    Raises ``ValueError`` for a device kind not in the table."""
    if device is None:
        import jax
        device = jax.devices()[0]
    kind = getattr(device, "device_kind", "")
    for key, peaks in _PEAKS.items():
        if key in kind.lower():
            return dict(peaks)
    raise ValueError(f"no peak rates known for device kind {kind!r}; "
                     f"known: {sorted(_PEAKS)}")


def device_peak_flops(device=None) -> float:
    """Peak f32-input matmul rate of ``device`` (TF32 tensor cores)."""
    return device_peaks(device)["tf32_flops_per_s"]


def _edge_shapes(problem):
    """Per edge type: (E, r, [slot tangent dims])."""
    out = {}
    for name, et in problem.edge_types.items():
        E = int(problem.data.edges[name].vidx.shape[0])
        r = int(et.residual_dim)
        dims = [vt.tangent_dim for vt in et.vertex_types]
        out[name] = (E, r, dims)
    return out


def linearize_flops(problem) -> float:
    """One linearization: residual + Jacobian production, robust weights,
    H-block/diagonal assembly, gradient, chi2.

    Per edge: J_s is (r, d_s) per slot (jacfwd ≈ one residual-sized matmul
    per tangent column → 2·r·Σd), W·J_s costs 2·r²·d_s, each H_ab block
    2·r·d_a·d_b (diagonal slots + upper off-diagonal pairs), b = JᵀWe
    2·r·Σd, chi2 2·r²."""
    total = 0.0
    for E, r, dims in _edge_shapes(problem).values():
        sd = sum(dims)
        j_prod = 2.0 * r * sd
        wj = sum(2.0 * r * r * d for d in dims)
        h_blocks = sum(2.0 * r * dims[a] * dims[b]
                       for a in range(len(dims))
                       for b in range(a, len(dims)))
        b_grad = 2.0 * r * sd
        chi2 = 2.0 * r * r
        total += E * (j_prod + wj + h_blocks + b_grad + chi2)
    return total


def chi2_flops(problem) -> float:
    """One chi2 evaluation (residual + eᵀΩe per edge)."""
    return sum(E * (2.0 * r * r + 4.0 * r)
               for E, r, _ in _edge_shapes(problem).values())


def matvec_flops(problem) -> float:
    """One damped full-system H·v: J·v and Jᵀ·u per slot + W·u."""
    total = 0.0
    for E, r, dims in _edge_shapes(problem).values():
        total += E * (sum(4.0 * r * d for d in dims) + 2.0 * r * r)
    for t, vt in problem.vertex_types.items():
        total += 2.0 * problem.counts[t] * vt.tangent_dim   # + λv
    return total


def _pcg_flops(problem, solver, cg_iters: float, trials: float) -> float:
    """PCGSolver: per-trial preconditioner build + cg_iters × (matvec +
    preconditioner apply + recurrence axpys)."""
    tangent = sum(problem.counts[t] * vt.tangent_dim
                  for t, vt in problem.vertex_types.items())
    axpy = 10.0 * tangent                       # x,r,p updates + dots
    precond = getattr(solver, "precond", "jacobi")
    if precond in ("chunk", "chunk2"):
        (tname,) = problem.vertex_types
        d = problem.vertex_types[tname].tangent_dim
        n = problem.counts[tname]
        c = solver.chunk_size
        nc = -(-n // c)
        cd = c * d
        build = nc * (cd ** 3 / 3.0 + 2.0 * cd ** 3)   # chol + inverse
        apply_ = 2.0 * nc * cd * cd
        if precond == "chunk2":
            ncd = nc * d
            build += ncd ** 3 / 3.0 + 2.0 * ncd ** 3
            build += sum(E * 2.0 * r * d * d
                         for E, r, _ in _edge_shapes(problem).values())
            apply_ += 2.0 * ncd * ncd
    else:
        build = sum(problem.counts[t] * vt.tangent_dim ** 3
                    for t, vt in problem.vertex_types.items())
        apply_ = sum(2.0 * problem.counts[t] * vt.tangent_dim ** 2
                     for t, vt in problem.vertex_types.items())
    return (trials * build
            + cg_iters * (matvec_flops(problem) + apply_ + axpy))


def _implicit_schur_flops(problem, solver, cg_iters: float,
                          trials: float) -> float:
    """ImplicitSchurSolver: per-trial setup (B blocks, Hll, Dinv,
    schur-jacobi diagonal, bschur) + cg_iters × reduced matvec."""
    marg = {t: bool(m.all()) for t, m in problem.marginalized.items()}
    pose_n = sum(problem.counts[t] for t, v in marg.items() if not v)
    dp = max((problem.vertex_types[t].tangent_dim
              for t, v in marg.items() if not v), default=0)
    dl = max((problem.vertex_types[t].tangent_dim
              for t, v in marg.items() if v), default=0)
    lm_n = sum(problem.counts[t] for t, v in marg.items() if v)

    # classify edge slots by their vertex type's marginalized flag (NOT by
    # tangent-dim equality: pose/landmark dims can coincide, and then the
    # dim-membership test misattributes FLOPs — advisor r2 finding)
    def _slot_marg(et):
        return [marg.get(vt.name, False) for vt in et.vertex_types]

    obs = 0.0
    setup = 0.0
    for name, (E, r, dims) in _edge_shapes(problem).items():
        sm = _slot_marg(problem.edge_types[name])
        if len(dims) == 2 and sm.count(True) == 1:
            obs += E
            # B = Jpᵀ W Jl, Hll contribution, Hpp contribution
            setup += E * (2.0 * r * r * dl + 2.0 * r * dp * dl
                          + 2.0 * r * dl * dl + 2.0 * r * dp * dp)
    setup += lm_n * dl ** 3                       # Dinv (3x3 closed form)
    setup += obs * 2.0 * dp * dl * (dp + dl)      # schur-jacobi diagonal
    setup += obs * 4.0 * dp * dl                  # bschur reduction
    setup += pose_n * dp ** 3                     # precond inverse

    # reduced S·v: Bᵀu, Dinv·t, B·s + Hpp·v (diag + pose-pose edges)
    mv = obs * 4.0 * dp * dl + lm_n * 2.0 * dl * dl + pose_n * 2.0 * dp * dp
    for name, (E, r, dims) in _edge_shapes(problem).items():
        if len(dims) == 2 and not any(_slot_marg(problem.edge_types[name])):
            mv += E * 4.0 * r * dp
    apply_ = pose_n * 2.0 * dp * dp
    axpy = 10.0 * pose_n * dp
    backsub = obs * 2.0 * dp * dl + lm_n * 2.0 * dl * dl
    return (trials * (setup + backsub)
            + cg_iters * (mv + apply_ + axpy))


def run_flops(problem, solver, res: dict) -> float | None:
    """Total algorithmic FLOPs of an ``optimize_fused`` result dict.
    Returns None when no model exists for the solver type."""
    iters = res.get("iterations", 0)
    cg = float(sum(res.get("cg_per_iteration", [])))
    trials = float(sum(res.get("trials_per_iteration", [iters]))) or iters
    name = getattr(solver, "name", "")
    if name == "pcg":
        per_solver = _pcg_flops(problem, solver, cg, trials)
    elif name == "schur_implicit":
        per_solver = _implicit_schur_flops(problem, solver, cg, trials)
    else:
        return None
    # each iteration: 1 linearize (includes chi2); each trial: apply + chi2
    return (iters * linearize_flops(problem)
            + trials * chi2_flops(problem)
            + per_solver)


def mfu_report(problem, solver, res: dict, device=None) -> dict | None:
    flops = run_flops(problem, solver, res)
    if flops is None or not res.get("wall_s"):
        return None
    peaks = device_peaks(device)
    achieved = flops / res["wall_s"]
    return {
        "algorithmic_flops": float(flops),
        "achieved_flops_per_s": float(achieved),
        "peak_tf32_flops_per_s": peaks["tf32_flops_per_s"],
        "peak_f32_flops_per_s": peaks["f32_flops_per_s"],
        "mfu_vs_tf32_peak": float(achieved / peaks["tf32_flops_per_s"]),
        "mfu_vs_f32_peak": float(achieved / peaks["f32_flops_per_s"]),
    }
