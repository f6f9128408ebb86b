"""The order and the plan of the port's batched SPD solve.

``spd_solve_warp_kernel`` factors each system up-looking: row ``i`` of
``U`` is summed from ``A``'s row ``i`` and the rows ``k < i`` of ``U``,
in windows of 256 columns from the 32-column group that holds the
diagonal, ``k`` in order, each product rounded before its subtraction; the right-looking plain version gives every entry the same
operations in the same order, so the two are bitwise equal.
``spd_solve_block_kernel`` (one block of 16 warps a system, the larger
ranks) keeps every entry's sequence but goes 32 rows at a time: all of
them take the steps ``k`` of earlier groups' rows first, then their row
pairs take the group's own earlier rows and are finished in order. Both orders are emulated in plain PyTorch, on the
CPU, and held against ``spd_solve_plain`` with ``torch.equal`` (and
against the JAX package's solves, to their own tolerance).
``spd_solve_plan`` picks the route and where its workspace lives; it is
checked at the shared memory an H100's block may opt into and its 132
SMs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from predictionio_tpu.ops import als_pallas
from predictionio_tpu_torch.ops import als_cuda

CHUNK = 256               # columns of a row one pass of the kernel covers
GROUP = 32                # a window starts at the diagonal's group of 32
H100_OPTIN = 232_448      # shared memory one block may opt into on an H100
H100_SMEM_PER_SM = 233_472
H100_SMS = 132
BLOCK_WARPS = 16          # spd_solve_block_kernel's warps (one system)


def up_looking_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's order: rows of U one at a time, each in 256-column
    windows from the diagonal's 32-column group, the pivot from the
    first; then the two sweeps."""
    B, R = b.shape
    U = torch.zeros((B, R, R), dtype=torch.float32)
    for i in range(R):
        c_first = i // GROUP * GROUP
        inv = None
        for cb in range(c_first, R, CHUNK):
            j = slice(max(cb, i), min(cb + CHUNK, R))
            s = A[:, i, j].clone()
            for k in range(i):
                prod = U[:, k, i:i + 1] * U[:, k, j]      # rounded
                s = s - prod                              # rounded
            if cb == c_first:
                inv = 1.0 / torch.sqrt(torch.clamp(s[:, 0], min=1e-30))
            U[:, i, j] = s * inv[:, None]
    return sweeps(U, b)


def sweeps(U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """U^T y = b, then U x = y, by columns, as both kernels run them."""
    R = b.shape[1]
    v = b.clone()
    for k in range(R):                                    # U^T y = b
        yk = v[:, k] / U[:, k, k]
        v[:, k] = yk
        v[:, k + 1:] = v[:, k + 1:] - U[:, k, k + 1:] * yk[:, None]
    for k in reversed(range(R)):                          # U x = y
        xk = v[:, k] / U[:, k, k]
        v[:, k] = xk
        v[:, :k] = v[:, :k] - U[:, :k, k] * xk[:, None]
    return v


def block_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The block kernel's order: for each 32 rows [w0, w0 + 32), every
    row first takes the steps k < w0 (the rows of earlier groups; the
    kernel's bulk, a warp a row pair), then the group's pairs in order
    take the steps k = w0 .. r - 1 (the group's rows finished before
    them), the pivots and u_{r,r+1}, and are written. Entries left of a
    row's diagonal are computed and never written, as in the kernel."""
    B, R = b.shape
    U = A.clone()
    for w0 in range(0, R, GROUP):
        rows = list(range(w0, min(R, w0 + GROUP)))
        for k in range(w0):                               # the bulk
            U[:, rows, w0:] = U[:, rows, w0:] - (
                U[:, k, rows][:, :, None] * U[:, k, None, w0:])
        for r in rows[::2]:                               # the tail
            pair = [r, r + 1] if r + 1 < R else [r]
            for k in range(w0, r):
                U[:, pair, w0:] = U[:, pair, w0:] - (
                    U[:, k, pair][:, :, None] * U[:, k, None, w0:])
            s0 = U[:, r, w0:]
            inv0 = 1.0 / torch.sqrt(torch.clamp(s0[:, r - w0], min=1e-30))
            u0 = s0 * inv0[:, None]
            U[:, r, r:] = u0[:, r - w0:]
            if r + 1 < R:
                t1 = U[:, r + 1, w0:] - u0[:, r + 1 - w0:r + 2 - w0] * u0
                inv1 = 1.0 / torch.sqrt(torch.clamp(t1[:, r + 1 - w0],
                                                    min=1e-30))
                U[:, r + 1, r + 1:] = (t1 * inv1[:, None])[:, r + 1 - w0:]
    return sweeps(U, b)


def spd_systems(seed: int, B: int, R: int, ill: bool = False):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((B, R, R)).astype(np.float32)
    A = G @ G.transpose(0, 2, 1)
    if ill:
        A = A * (10.0 ** rng.uniform(-2, 2, (B, 1, 1))).astype(np.float32) \
            + 0.01 * np.eye(R, dtype=np.float32)
    else:
        A = A / R + np.eye(R, dtype=np.float32)
    b = rng.standard_normal((B, R)).astype(np.float32)
    return torch.from_numpy(A.astype(np.float32)), torch.from_numpy(b)


class TestKernelOrder:
    @pytest.mark.parametrize("R,B", [(1, 16), (31, 8), (32, 8), (33, 8),
                                     (64, 8), (65, 4), (257, 2), (300, 2)])
    def test_bitwise_equal_to_plain(self, R, B):
        A, b = spd_systems(R, B, R)
        x = up_looking_solve(A, b)
        assert torch.equal(x, als_cuda.spd_solve_plain(A, b))

    def test_ill_scaled_bitwise(self):
        A, b = spd_systems(7, 16, 40, ill=True)
        assert torch.equal(up_looking_solve(A, b),
                           als_cuda.spd_solve_plain(A, b))

    def test_only_the_upper_triangle_is_read(self):
        A, b = spd_systems(3, 4, 33)
        junk = torch.triu(A) + torch.tril(torch.full_like(A, 7.0), -1)
        assert torch.equal(up_looking_solve(junk, b),
                           als_cuda.spd_solve_plain(A, b))

    @pytest.mark.parametrize("R,B", [(240, 3), (256, 2), (63, 4), (97, 3)])
    def test_block_order_bitwise_equal_to_plain(self, R, B):
        A, b = spd_systems(R + 1, B, R)
        assert torch.equal(block_solve(A, b), als_cuda.spd_solve_plain(A, b))

    def test_block_order_ill_scaled_bitwise(self):
        A, b = spd_systems(8, 4, 70, ill=True)
        assert torch.equal(block_solve(A, b), als_cuda.spd_solve_plain(A, b))

    @pytest.mark.parametrize("R", [128, 256])
    def test_large_rank_agrees_with_the_jax_lanes_solve(self, R):
        """The port's solve on the CPU (its plain version, which the
        kernels equal bitwise) against the JAX package's large-rank
        solve (``spd_solve_lanes``, which JAX's ``_solve_rows`` takes
        above the Pallas solve's rank 96): both fp32 Cholesky solves of
        systems of condition about 5, in other orders, so they agree to
        within 1e-4 of the largest entry."""
        from predictionio_tpu.ops.als import spd_solve_lanes
        A, b = spd_systems(5 + R, 3, R)
        want = np.asarray(spd_solve_lanes(jnp.asarray(A.numpy()),
                                          jnp.asarray(b.numpy())))
        got = als_cuda.spd_solve(A, b).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())

    @pytest.mark.parametrize("R", [8, 65])
    def test_agrees_with_the_jax_solve(self, R):
        A, b = spd_systems(11 + R, 8, R)
        want = np.asarray(als_pallas.spd_solve(jnp.asarray(A.numpy()),
                                               jnp.asarray(b.numpy()),
                                               interpret=True))
        np.testing.assert_allclose(up_looking_solve(A, b).numpy(), want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())


class TestSpdSolvePlan:
    @pytest.mark.parametrize("R,route,warps", [
        (1, "shared", 8),
        (64, "shared", 8),
        (239, "shared", 2),         # the largest shared-route rank
        (240, "block", 16),         # one block a system from here
        (241, "block", 16),
        (256, "block", 16),
        (320, "block", 16),
        (339, "block", 16),         # the largest workspace a block holds
        (340, "device", 16),        # the block route in device memory
    ])
    def test_route_and_warps(self, R, route, warps):
        plan = als_cuda.spd_solve_plan(R, H100_OPTIN, H100_SMS)
        assert (plan.route, plan.warps_per_block) == (route, warps)
        ws = R * (R + 1) // 2 + R
        assert plan.workspace_floats == (
            ws if route == "shared" else ws + als_cuda.SPD_BLOCK_SCALARS)

    def test_largest_shared_rank(self):
        shared = [R for R in range(1, 400)
                  if als_cuda.spd_solve_plan(R, H100_OPTIN, H100_SMS).route
                  == "shared"]
        assert shared == list(range(1, 240))

    def test_block_route_ranks(self):
        """The block route holds its workspace (132,608 bytes of
        triangle and v at R = 256, 206,720 at 320, and the pivot
        scalars) in shared memory up to R = 339."""
        block = [R for R in range(1, 400)
                 if als_cuda.spd_solve_plan(R, H100_OPTIN, H100_SMS).route
                 == "block"]
        assert block == list(range(240, 340))
        for R, nbytes in ((256, 132_608), (320, 206_720)):
            plan = als_cuda.spd_solve_plan(R, H100_OPTIN, H100_SMS)
            assert 4 * plan.workspace_floats == \
                nbytes + 4 * als_cuda.SPD_BLOCK_SCALARS <= H100_OPTIN

    def test_r64_fills_the_sm(self):
        """Three blocks of 8 warps (each block reserves 1 KB besides its
        workspaces) share an H100 SM: 24 resident warps."""
        plan = als_cuda.spd_solve_plan(64, H100_OPTIN, H100_SMS)
        block = 4 * plan.warps_per_block * plan.workspace_floats
        assert block == 8 * 2144 * 4 <= H100_OPTIN
        assert 3 * (block + 1024) <= H100_SMEM_PER_SM

    @pytest.mark.parametrize("R", [340, 341, 384, 1000, 4000, 20_000])
    def test_device_slots_are_bounded(self, R):
        plan = als_cuda.spd_solve_plan(R, H100_OPTIN, H100_SMS)
        assert plan.route == "device"
        assert plan.warps_per_block == BLOCK_WARPS
        assert 1 <= plan.slots <= als_cuda.SPD_DEVICE_BLOCKS_PER_SM * H100_SMS
        assert (plan.slots * plan.workspace_floats * 4
                <= als_cuda.SPD_DEVICE_BYTES or plan.slots == 1)

    def test_bad_rank_raises(self):
        with pytest.raises(ValueError):
            als_cuda.spd_solve_plan(0, H100_OPTIN, H100_SMS)


class TestWrapper:
    @pytest.mark.parametrize("R", [33, 257])
    def test_cpu_runs_the_plain_version_at_any_rank(self, R):
        A, b = spd_systems(R, 2, R)
        assert torch.equal(als_cuda.spd_solve(A, b),
                           als_cuda.spd_solve_plain(A, b))
