"""Distributed block-tridiagonal solve by Schur-complement domain decomposition.

Port of `lidar_graph_slam_tpu/parallel/schur.py`. The chain's block-tridiagonal normal
system decomposes across the mesh's slots (`parallel/distributed.py:Mesh`):

  * the K poses are split into `n` contiguous segments; the last pose of each segment is
    a *separator*, the rest are *interior*;
  * each slot eliminates its interior system locally (`graph/solver.py:_tridiag_solve`);
  * the elimination condenses onto the separator system (one 6x6 block per slot), which
    is `psum`-reduced, solved once, and handed back to every slot;
  * each slot back-substitutes its interior.

One `psum` of n x 6 x 6 blocks (and the right-hand sides) is the only reduction; one
`ppermute` hands each slot its predecessor's coupling block. On a mesh that spans
processes each process eliminates its own slots' interiors, and the slots' solutions are
all-gathered at the end, so every process returns the whole solution. Loop factors compose on top
through the same Woodbury identity as the single-device solver. The assembly, the solve
and the finish run as plain calls one after the other (the reference separates its
assembly and solve into two compiled programs only to avoid a miscompile of its CPU
backend).
"""

from __future__ import annotations

import torch

from lidar_graph_slam_tpu_torch.core import se3
from lidar_graph_slam_tpu_torch.graph import solver as gsolver
from lidar_graph_slam_tpu_torch.parallel.distributed import (
    Mesh,
    all_slots,
    ppermute,
    psum,
    tree_to,
)


def _local_tridiag_solve(D, U, B):
    """One slot's block-tridiagonal solve (interior elimination / separator system)."""
    if D.shape[0] == 0:
        return B
    return gsolver._tridiag_solve(D, U, B)


def schur_tridiag_solve(mesh: Mesh, D_blocks, U_blocks, B):
    """Solve the block-tridiagonal system H x = B across the mesh.

    D_blocks: [K, 6, 6]; U_blocks: [K, 6, 6] with U_blocks[k] = H[k, k+1]
    (U_blocks[K-1] must be zero); B: [K, 6, M]. K must divide by the mesh size, with at
    least 2 poses per slot. Returns x [K, 6, M] on the inputs' device.
    """
    K = D_blocks.shape[0]
    n_dev = mesh.size
    assert K % n_dev == 0, f"K={K} not divisible by mesh size {n_dev}"
    m = K // n_dev
    M = B.shape[-1]
    dtype = D_blocks.dtype
    slots = mesh.local_slots
    U_loc = [U_blocks[d * m:(d + 1) * m].to(mesh.devices[d]) for d in slots]
    # Coupling from the previous separator into each slot's first interior pose.
    U_prev_last = ppermute(mesh, [u[m - 1] for u in U_loc])

    parts, local = [], []
    for j, d in enumerate(slots):
        dev = mesh.devices[d]
        Dl, Ul, Bl = D_blocks[d * m:(d + 1) * m].to(dev), U_loc[j], B[d * m:(d + 1) * m].to(dev)
        U_prev = U_prev_last[j] if d > 0 else torch.zeros((6, 6), dtype=dtype, device=dev)
        # Interior system: poses 0..m-2; separator: pose m-1.
        D_int = Dl[: m - 1]
        U_int = Ul[: m - 2] if m > 2 else torch.zeros((0, 6, 6), dtype=dtype, device=dev)
        b_int = Bl[: m - 1]
        # RHS bundle [b | C | B]: C nonzero only in interior row 0 (= U_prev^T), B only in
        # interior row m-2 (= U_loc[m-2]).
        C_cols = torch.zeros((m - 1, 6, 6), dtype=dtype, device=dev)
        C_cols[0] = U_prev.transpose(0, 1)
        B_cols = torch.zeros((m - 1, 6, 6), dtype=dtype, device=dev)
        B_cols[m - 2] = Ul[m - 2]
        sol = _local_tridiag_solve(D_int, U_int, torch.cat([b_int, C_cols, B_cols], dim=-1))
        y, W_C, W_B = sol[..., :M], sol[..., M:M + 6], sol[..., M + 6:]

        # Separator contributions: C^T T^-1 X = U_prev @ (T^-1 X)[0];
        # B^T T^-1 X = U_loc[m-2]^T @ (T^-1 X)[m-2].
        Ct = U_prev
        Bt = Ul[m - 2].transpose(0, 1)
        S_diag = torch.zeros((n_dev, 6, 6), dtype=dtype, device=dev)
        S_off = torch.zeros((n_dev, 6, 6), dtype=dtype, device=dev)  # sep d -> sep d+1
        S_rhs = torch.zeros((n_dev, 6, M), dtype=dtype, device=dev)
        S_diag[d] += Dl[m - 1]
        S_rhs[d] += Bl[m - 1]
        if d > 0:  # elimination of this interior reduces onto separator d-1 as well
            S_diag[d - 1] += -(Ct @ W_C[0])
            S_off[d - 1] += -(Ct @ W_B[0])
            S_rhs[d - 1] += -(Ct @ y[0])
        S_diag[d] += -(Bt @ W_B[m - 2])
        S_rhs[d] += -(Bt @ y[m - 2])
        parts.append((S_diag, S_off, S_rhs))
        local.append((y, W_C, W_B))

    S_diag, S_off, S_rhs = psum(mesh, parts)[0]
    # The separator system (n_dev blocks), solved once and handed to every slot.
    x_sep = tree_to(_local_tridiag_solve(S_diag, S_off[: n_dev - 1], S_rhs), D_blocks.device)

    out = []
    for d, (y, W_C, W_B) in zip(slots, local):
        x_sep_d = x_sep.to(y.device)
        x_prev = x_sep_d[d - 1] if d > 0 else torch.zeros((6, M), dtype=dtype, device=y.device)
        x_own = x_sep_d[d]
        x_int = y - W_C @ x_prev - W_B @ x_own
        out.append(torch.cat([x_int, x_own[None]]))
    return torch.cat([x.to(D_blocks.device) for x in all_slots(mesh, out)])


def _schur_assemble(g: gsolver.PoseGraph, damping):
    """The single-device chain assembly, the padded coupling blocks and the right-hand
    sides with the loop factors' whitened Woodbury columns."""
    dtype = g.poses.dtype
    D, U, b = gsolver._assemble_chain(
        g, g.poses, torch.as_tensor(damping, dtype=dtype, device=g.poses.device))
    U_pad = torch.cat([U, torch.zeros((1, 6, 6), dtype=dtype, device=U.device)])
    b_loop, Vw = gsolver.loop_gradient_and_whitened_columns(g, g.poses)
    rhs = torch.cat([(b + b_loop)[..., None], Vw], dim=-1)
    return D, U_pad, rhs, Vw


def _schur_finalize(g: gsolver.PoseGraph, Vw, sol):
    delta = gsolver.woodbury_correct(Vw, sol[..., 0], sol[..., 1:])
    delta = torch.where(torch.isfinite(delta), delta, 0.0)
    return g.poses @ se3.se3_exp(delta)


def schur_graph_step(mesh: Mesh, g: gsolver.PoseGraph, damping=1e-4):
    """One damped-GN pose-graph step with the Schur-distributed tridiagonal solve: the
    single-device assembly, then the chain and Woodbury solve domain-decomposed over the
    mesh. Returns the updated poses [K, 4, 4]."""
    D, U_pad, rhs, Vw = _schur_assemble(g, damping)
    sol = schur_tridiag_solve(mesh, D, U_pad, rhs)
    return _schur_finalize(g, Vw, sol)
