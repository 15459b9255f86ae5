"""A model of ``python_fluid_simulation_tpu_torch/csrc/poisson_pcg.cu``
over torch tensors on the CPU: its init (a warp's 32-cell flag
word, each block's run of words, the blocks' counts and offsets), its
two phases an iteration over the live list, grid stride, and its order
of dot partials (a thread's cells in turn, the warp shuffle tree, the
block's warps, then every block's partials) for a given block count.
kBlock is read from the source.

tests/test_torch_poisson_live.py holds the model against the JAX
package's Poisson PCGs on the CPU; ``chip_smoke.py`` (phase `kernels`)
holds the kernel on the card against the model, bitwise, on the
flagship's pressure and density systems at the block count the kernel
launched with.  The model imports no JAX.
"""

import re

import torch

from python_fluid_simulation_tpu_torch.ops import _cuda_build, cuda_stencils

K_BLOCK = int(re.search(r"constexpr int kBlock = (\d+);", (_cuda_build.SRC_DIR / "poisson_pcg.cu").read_text()).group(1))


def _warp_tree(v):
    """Lane 0's value after `block_sum`'s shuffle-down tree over the last
    axis (32 lanes)."""
    for o in (16, 8, 4, 2, 1):
        v = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def _block_sum(v):
    """pcg_common.cuh::block_sum of (blocks, K_BLOCK) per-thread values:
    each warp's tree, then warp 0's tree over the warps' sums (zero
    padded)."""
    warps = _warp_tree(v.reshape(v.shape[0], K_BLOCK // 32, 32))
    pad = torch.zeros(v.shape[0], 32, dtype=v.dtype)
    pad[:, :K_BLOCK // 32] = warps
    return _warp_tree(pad)


def _grid_total(part):
    """pcg_common.cuh::grid_total: thread j sums partials j, j + K_BLOCK,
    ... in turn, then the block sums its threads."""
    thread = torch.zeros(K_BLOCK, dtype=part.dtype)
    for j in range(part.shape[0]):
        thread[j % K_BLOCK] = thread[j % K_BLOCK] + part[j]
    return _block_sum(thread[None])[0]


def _thread_sums(rows):
    """(M, blocks, K_BLOCK) values a thread meets in turn -> per-thread sums."""
    acc = torch.zeros(rows.shape[1:], dtype=rows.dtype)
    for m in range(rows.shape[0]):
        acc = acc + rows[m]
    return acc


def _list_dot(vals, nb):
    """A dot over the live list: entry t is thread t % (nb K_BLOCK)'s, in
    the grid-stride order."""
    stride = nb * K_BLOCK
    m = max(-(-vals.shape[0] // stride), 1)
    rows = torch.zeros(m * stride, dtype=vals.dtype)
    rows[:vals.shape[0]] = vals
    return _grid_total(_block_sum(_thread_sums(rows.reshape(m, nb, K_BLOCK))))


def _block_words(nwords, nb):
    per = -(-nwords // nb)
    return [(min(k * per, nwords), min(k * per + per, nwords)) for k in range(nb)]


def _init_dot(cell_vals, nb):
    """A dot of the init's pass 1: block k's words [wbeg, wend), warp w
    takes words wbeg + w, wbeg + w + K_BLOCK / 32, ..., lane l cell 32 word + l."""
    n = cell_vals.numel()
    nwords = -(-n // 32)
    padded = torch.zeros(nwords * 32, dtype=cell_vals.dtype)
    padded[:n] = cell_vals.reshape(-1)
    warps = K_BLOCK // 32
    part = torch.zeros(nb, dtype=cell_vals.dtype)
    for k, (wb, we) in enumerate(_block_words(nwords, nb)):
        m = max(-(-(we - wb) // warps), 1)
        rows = torch.zeros(m * warps * 32, dtype=cell_vals.dtype)
        rows[:(we - wb) * 32] = padded[wb * 32:we * 32]
        part[k] = _block_sum(_thread_sums(rows.reshape(m, 1, K_BLOCK)))[0]
    return _grid_total(part)


def _live_list(live, nb):
    """Pass 2: each block's live cells in ascending order, at the offset of
    the counts of the blocks before it."""
    flat = live.reshape(-1)
    nwords = -(-flat.numel() // 32)
    spans = [torch.nonzero(flat[wb * 32:we * 32]).reshape(-1) + wb * 32 for wb, we in _block_words(nwords, nb)]
    return torch.cat(spans) if spans else torch.zeros(0, dtype=torch.int64)


def list_pcg(b, x0, diag, coefs, pd, *, tol2, rel2, max_iter, nb):
    """The kernel's solve over torch tensors: returns
    (x, iters, res, res0, live list)."""
    mv = cuda_stencils.stencil_matvec_plain
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b.clone() if x0 is None else b - mv(diag, coefs, x0)
    live = (r != 0) | (diag != 0)
    for _, c in coefs:
        live = live | (c != 0)
    act = _live_list(live, nb)
    delta = _init_dot(r * (r / pd), nb)
    res0 = _init_dot(r * r, nb)
    thresh = torch.clamp(torch.tensor(rel2, dtype=torch.float32) * res0, min=torch.tensor(tol2, dtype=torch.float32))
    d = torch.zeros_like(b)
    res, beta, k = res0, torch.zeros((), dtype=torch.float32), 0
    xf, rf = x.reshape(-1), r.reshape(-1)
    while bool(res >= thresh) and k < max_iter and bool(delta != 0):
        # A: the direction on every cell is 0 off the list, as the kernel's
        # zeroed buffers give; q = A d on the list
        d = beta * d + r / pd
        q = mv(diag, coefs, d).reshape(-1)[act]
        dl = d.reshape(-1)[act]
        dq = _list_dot(dl * q, nb)
        alpha = torch.where(dq != 0, delta / dq, torch.zeros_like(dq))
        # B
        xf[act] = xf[act] + alpha * dl
        rl = rf[act] - alpha * q
        rf[act] = rl
        pdl = pd.reshape(-1)[act]
        new_delta = _list_dot(rl * (rl / pdl), nb)
        res = _list_dot(rl * rl, nb)
        beta = torch.where(delta != 0, new_delta / delta, torch.zeros_like(delta))
        delta = new_delta
        k += 1
    return x, k, res, res0, act
