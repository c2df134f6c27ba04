"""K2 on many lanes per ray (``csrc/fused_sample_pdf.cu``,
``sample_pdf_lanes_kernel``): LANES lanes per ray, the CDF in the plain
version's sequential order, each lane's own search and walks over a span of
consecutive samples, and every output position by rank.

On the CPU a pure-Python model of the kernel (its split of the fine samples
into the lanes' spans, its searches and walks, its float32 operations in
their order, each value's position from its rank and the count of writes to
each position, and the vote that sends a row whose fine depths come out of
order to lane 0's sort and merge)
is held bit for bit against ``sample_pdf_merge_plain`` on adversarial rows:
ties between z and the fine depths, repeated z, K = 1, S = 3, all-zero
weights, and fine depths one ulp out of order; the block's shared memory and
the launch counters.

Tests marked ``cuda`` build and launch the kernels and skip without a card:
the kernel on the path and the first port against the plain version at the
shapes of ``chip_smoke.py``'s K2 checks and on the adversarial rows.  The file
imports no JAX."""

import bisect
import os
import sys

import numpy as np
import pytest
import torch

from sinnerf_tpu_torch.ops import fused_sample_pdf as k2
from sinnerf_tpu_torch.ops.fused_sample_pdf import sample_pdf_merge_plain

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

F = np.float32
EPS = F(k2.EPS)
SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on an H100
SM_SMEM = 233_472  # bytes of shared memory of one H100 SM (1 KB of it reserved per block)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


def _count_le(a, v) -> int:
    return bisect.bisect_right(a, v)


def model_cdf(w):
    """Step 2: the sum in sequential order (lane 0), the quotients (each
    lane its share: the same operation wherever it runs), the sequential
    adds (lane 0): the CDF [0, m]."""
    m = len(w) - 2
    total = F(0)
    for j in range(1, m + 1):
        total = F(total + F(F(w[j]) + EPS))
    c, acc = [F(0)], F(0)
    for j in range(1, m + 1):
        acc = F(acc + F(F(F(w[j]) + EPS) / total))
        c.append(acc)
    return c


def _u_value(u, i, rcp, det):
    return F(F(i) * rcp) if det else F(F(F(i) + F(u[i])) * rcp)


def _fine_depth(cdf, z, cnt, uu):
    m = len(cdf) - 1
    below, above = max(cnt - 1, 0), min(cnt, m)
    lo, hi = cdf[below], cdf[above]
    b_lo = F(F(0.5) * F(z[below] + z[below + 1]))
    b_hi = F(F(0.5) * F(z[above] + z[above + 1]))
    denom = F(hi - lo)
    if denom < EPS:
        denom = F(1)
    return F(b_lo + F(F(F(uu - lo) / denom) * F(b_hi - b_lo)))


def lane_spans(k):
    """Step 3's split: lane l takes the fine samples [l c, l c + c) of [0, K),
    c = ceil(K / LANES); the lanes past K take none."""
    c = -(-k // k2.LANES)
    return [(min(lane * c, k), min(lane * c + c, k)) for lane in range(k2.LANES)]


def model_lanes(z, cdf, k, u, det):
    """Step 3: each lane's samples in order (a search for the bin of its
    first, a walk to each next, a search again where u falls), zf_i, its
    rank p_i by a walk from the bin, zf_i to i + p_i and z_a with p_{i-1} <= a
    < p_i to a + i; a lane's first takes the z after the previous lane's last,
    the last lane those after zf_{K-1}.  Returns the row, the count of writes
    to each position and zf."""
    s, m = len(z), len(cdf) - 1
    rcp = F(F(1) / F(max(k - 1, 1) if det else k))
    out, hits, zf = [None] * (s + k), np.zeros(s + k, dtype=int), [None] * k
    p_of = {}

    def put(pos, v):
        out[pos] = v
        hits[pos] += 1

    spans = lane_spans(k)
    for first, last in spans:
        cnt, uu_prev = 0, F(0)
        for i in range(first, last):
            uu = _u_value(u, i, rcp, det)
            if i == first or uu < uu_prev:
                cnt = _count_le(cdf, uu)
            else:
                while cnt <= m and cdf[cnt] <= uu:
                    cnt += 1
            assert cnt == _count_le(cdf, uu)
            uu_prev = uu
            zf[i] = _fine_depth(cdf, z, cnt, uu)
            p = max(cnt, 1)
            while p < s and z[p] <= zf[i]:
                p += 1
            assert p == _count_le(z, zf[i])
            p_of[i] = p
            put(i + p, zf[i])
            if i > first:
                for a in range(p_of[i - 1], p):
                    put(a + i, z[a])
    for lane, (first, last) in enumerate(spans):
        if first < last:
            for a in range(0 if lane == 0 else p_of[first - 1], p_of[first]):
                put(a + first, z[a])
            if last == k:
                for a in range(p_of[k - 1], s):
                    put(a + k, z[a])
    return out, hits, zf


def inverted(zf):
    """Step 4's vote: a lane sees zf_i < zf_{i-1} inside its span or between
    its first and the previous lane's last: any pair of neighbours."""
    return any(zf[i] < zf[i - 1] for i in range(1, len(zf)))


def model_slow_merge(z, zf):
    """Step 4's lane 0 alone: an insertion sort of zf, then a two-pointer
    merge, z first on ties."""
    f = list(zf)
    for i in range(1, len(f)):
        v, j = f[i], i - 1
        while j >= 0 and f[j] > v:
            f[j + 1] = f[j]
            j -= 1
        f[j + 1] = v
    out, b = [], 0
    for v in f:
        while b < len(z) and z[b] <= v:
            out.append(z[b])
            b += 1
        out.append(v)
    return np.array(out + list(z[b:]), dtype=F)


def model_ray(z, w, k, u, det):
    """The kernel on one ray: (row, zf, whether lane 0 merged it alone)."""
    zr = [F(x) for x in z]
    out, hits, zf = model_lanes(zr, model_cdf(w), k, u, det)
    if inverted(zf):
        return model_slow_merge(zr, zf), zf, True
    assert (hits == 1).all(), f"positions written {hits.tolist()}"
    return np.array(out, dtype=F), zf, False


def model(z, w, k, u, det):
    """The kernel on rows z, w (N, S) and u (N, K) or None: (N, S + K) and
    the rows' fine depths before the merge."""
    rays = [model_ray(z[r], w[r], k, None if det else u[r], det) for r in range(z.shape[0])]
    return np.stack([r[0] for r in rays]), np.array([r[1] for r in rays], dtype=F)


# --------------------------------------------------------------------------
# adversarial rows
# --------------------------------------------------------------------------


def _repeated_pairs(rng, n, s):
    """Ascending z whose columns come in equal pairs: the bin edge between a
    pair is the pair's value, so a fine depth at a bin edge ties with z."""
    half = np.sort(rng.uniform(2, 6, size=(n, (s + 1) // 2)), axis=1)
    return np.repeat(half, 2, axis=1)[:, :s].astype(F)


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    z = np.sort(rng.uniform(2, 6, size=(6, 64)), axis=1).astype(F)
    w = (rng.uniform(size=(6, 64)) ** 4).astype(F)
    k = 128
    if name == "ties_z_zf":  # the first u (det 0; drawn u_0 = 0 below) lands on the first edge, z0 = z1
        z = _repeated_pairs(rng, 6, 64)
    elif name == "u_zero":  # stochastic u = 0: every u_i at its stratum's start, equal weights
        z = _repeated_pairs(rng, 6, 16)
        w = np.ones((6, 16), dtype=F)
        k = 24
    elif name == "repeated_z":  # a run of one value, and a row of one value
        z[:, 10:30] = z[:, 10:11]
        z[0] = F(3.5)
    elif name == "k1":
        k = 1
    elif name == "s3":
        z, w, k = z[:, ::21][:, :3].copy(), w[:, :3].copy(), 40
    elif name == "zero_weights":
        w[:] = 0
    elif name == "one_hot_weights":  # the pdf's guard bins: denom < 1e-5 -> 1
        w[:] = 0
        w[:, 17] = 1
    u = (np.zeros((6, k)) if name == "u_zero" else rng.uniform(size=(6, k))).astype(F)
    if name == "ties_z_zf":
        u[:, ::3] = 0
    return z, w, k, u


CASES = ("ties_z_zf", "u_zero", "repeated_z", "k1", "s3", "zero_weights", "one_hot_weights")


@pytest.mark.parametrize("det", [True, False])
@pytest.mark.parametrize("name", CASES)
def test_model_equals_the_plain_version(name, det):
    """The model's rows equal ``sample_pdf_merge_plain``'s bit for bit (and
    every position is written once, which the model asserts)."""
    z, w, k, u = _case(name)
    got, zf = model(z, w, k, u, det)
    want = sample_pdf_merge_plain(torch.from_numpy(z), torch.from_numpy(w), k, None if det else torch.from_numpy(u),
                                  det).numpy()
    assert got.shape == want.shape == (z.shape[0], z.shape[1] + k)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert (got[:, 1:] >= got[:, :-1]).all()
    if name in ("ties_z_zf", "u_zero"):  # the case holds what it says: a fine depth equal to a coarse one
        assert all(np.intersect1d(z[r], zf[r]).size for r in range(z.shape[0]))


@pytest.mark.parametrize("s,k,det", [(64, 128, True), (64, 128, False), (64, 64, False), (9, 12, True),
                                     (9, 200, False)])
def test_model_equals_the_plain_version_on_drawn_rows(s, k, det):
    rng = np.random.default_rng(7 + s + k)
    z = np.sort(rng.uniform(2, 6, size=(4, s)), axis=1).astype(F)
    w = (rng.uniform(size=(4, s)) ** 4).astype(F)
    u = rng.uniform(size=(4, k)).astype(F)
    got, _ = model(z, w, k, u, det)
    want = sample_pdf_merge_plain(torch.from_numpy(z), torch.from_numpy(w), k, None if det else torch.from_numpy(u),
                                  det).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("where", ["tie_with_z", "z_between", "ends"])
def test_lane_0_merges_fine_depths_one_ulp_out_of_order(where):
    """Fine depths out of order by one ulp at a bin edge: the vote sees it,
    and lane 0's sort and two-pointer merge give ``sort(cat(z, zf))``, where
    the lanes' ranks would not (``z_between``: a z strictly between the two
    would take a fine depth's position)."""
    x = F(3.0)
    up = np.nextafter(x, F(4))
    zf = [F(2.0), F(2.5), up, x, F(3.5), F(5.0)]
    z = {"tie_with_z": [F(1.0), x, x, F(4.0)],
         "z_between": [F(1.0), up, F(4.5)],
         "ends": [x, up, F(6.0)]}[where]
    if where == "z_between":  # 3 < z < zf[2]
        zf[2] = np.nextafter(up, F(4))
    assert inverted(zf)
    assert np.array_equal(model_slow_merge(z, zf), np.sort(np.array(z + zf, dtype=F)))


@pytest.mark.parametrize("k", [1, 15, 16, 17, 40, 128, 200])
def test_lane_spans_cover_every_sample_once(k):
    """Consecutive spans from lane 0 on, each right after the previous one:
    every fine sample once, the lanes past K empty."""
    spans = lane_spans(k)
    assert [i for first, last in spans for i in range(first, last)] == list(range(k))
    active = [first < last for first, last in spans]
    assert active == sorted(active, reverse=True)


def test_lanes_shared_memory():
    """Per ray: z, the bin edges, w (+4 floats: warp 0's walks over the
    block's rows on other banks), the fine depths and the output row, each
    rounded up to 16 bytes; 16 rays a block of 256 threads.  At S = 64, K =
    128 six blocks (48 warps) fit on an SM, where the first port's 41 KB
    blocks of one warp fit five."""
    assert k2.LANES * k2.RAYS_PER_BLOCK == 256 and 32 % k2.LANES == 0
    assert k2.lanes_smem_bytes(64, 128) == 16 * (64 + 64 + 68 + 128 + 192) * 4 == 33_024
    assert k2.lanes_smem_bytes(3, 1) == 16 * (4 + 4 + 8 + 4 + 4) * 4
    assert SM_SMEM // (k2.lanes_smem_bytes(64, 128) + 1024) == 6
    assert SM_SMEM // ((2 * 65 + 193) * 32 * 4 + 1024) == 5  # the first port's blocks
    for s, k in ((3, 1), (9, 12), (64, 1), (64, 64), (64, 128)):
        assert k2.lanes_smem_bytes(s, k) % 16 == 0 and k2.lanes_smem_bytes(s, k) <= SMEM_LIMIT


def test_cpu_tensors_count_no_launch_and_the_first_port_needs_the_card():
    z, w, k, u = _case("k1")
    before = k2.fused_sample_pdf_merge.launches, k2.launch_sample_pdf_merge_earlier.launches
    k2.fused_sample_pdf_merge(torch.from_numpy(z), torch.from_numpy(w), k, torch.from_numpy(u), False)
    with pytest.raises(ValueError):
        k2.launch_sample_pdf_merge_earlier(torch.from_numpy(z), torch.from_numpy(w), k)
    for part in ("rows", "cdf", "all"):  # the timing cuts: card only, and only those two
        with pytest.raises(ValueError):
            k2.launch_sample_pdf_merge_parts(part, torch.from_numpy(z), torch.from_numpy(w), k)
    assert (k2.fused_sample_pdf_merge.launches, k2.launch_sample_pdf_merge_earlier.launches) == before


def test_the_k2_module_imports_no_jax():
    import re

    src = open(k2.__file__).read()
    assert not re.search(r"^\s*(import|from)\s+(jax|sinnerf_tpu)\b", src, re.M)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _hold(got, want, what):
    assert got.shape == want.shape and bool((got[:, 1:] >= got[:, :-1]).all()), what
    rtol, atol = chip_smoke.K2_TOL
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all()), what
    return bool(torch.equal(got, want))


@pytest.mark.cuda
def test_k2_kernels_match_plain(cuda_device):
    """Both kernels at the shapes of chip_smoke.py's K2 checks, within
    K2_TOL (expected bit-equal; how many were is printed), one launch each."""
    rng = np.random.default_rng(3)
    equal = 0
    for n, s, k, det in ((4096, 64, 64, True), (4096, 64, 64, False), (4096, 64, 128, True),
                         (4096, 64, 128, False), (4096, 64, 1, True), (4096, 64, 1, False),
                         (1000, 64, 128, True), (1000, 64, 128, False), (131_072, 64, 128, True),
                         (16_384, 64, 128, False), (333, 9, 12, False), (333, 10, 201, False)):
        _, z = chip_smoke.make_rays(rng, n, s, cuda_device)
        w = torch.tensor(rng.uniform(size=(n, s)) ** 4, dtype=torch.float32, device=cuda_device)
        u = None if det else torch.tensor(rng.uniform(size=(n, k)), dtype=torch.float32, device=cuda_device)
        want = sample_pdf_merge_plain(z, w, k, u, det)
        before = k2.fused_sample_pdf_merge.launches, k2.launch_sample_pdf_merge_earlier.launches
        for launch in (k2.fused_sample_pdf_merge, k2.launch_sample_pdf_merge_earlier):
            got = launch(z, w, k, u, det)
            torch.cuda.synchronize()
            equal += _hold(got, want, f"{launch.__name__} n={n} S={s} K={k} det={det}")
        assert (k2.fused_sample_pdf_merge.launches, k2.launch_sample_pdf_merge_earlier.launches) == (
            before[0] + 1, before[1] + 1)
    print(f"{equal} of 24 launches bit-equal to the plain version")


@pytest.mark.cuda
@pytest.mark.parametrize("det", [True, False])
def test_k2_kernel_on_adversarial_rows(cuda_device, det):
    """The kernel on the path on the adversarial rows: bit for bit the plain
    version's (and the model's)."""
    for name in CASES:
        z, w, k, u = _case(name)
        zc, wc, uc = (torch.from_numpy(a).to(cuda_device) for a in (z, w, u))
        got = k2.fused_sample_pdf_merge(zc, wc, k, None if det else uc, det)
        torch.cuda.synchronize()
        want = sample_pdf_merge_plain(zc, wc, k, None if det else uc, det)
        assert torch.equal(got, want), name
        assert np.array_equal(got.cpu().numpy(), model(z, w, k, u, det)[0]), name
        for part in k2.PARTS:  # the timing cuts launch and keep the row's shape
            assert k2.launch_sample_pdf_merge_parts(part, zc, wc, k, None if det else uc, det).shape == got.shape
