"""Analysis / plotting suite over the framework's text outputs (the port's own
copy of :mod:`gple_tpu.plotting.plots`, whose package imports JAX).

Covers the capabilities of the reference's four plot scripts:

* GPLE run diagnostics + averages + parameter trajectories + animated phase
  space (``gaussian_process_liouville_equation/plot.py``)
* Schroedinger psi / phase-space animations (``schrodinger_equation/plot_psi.py``,
  ``plot_phase.py``)
* Liouville population + PWTDM contours (``liouville_equation/plot.py``)
* validation traces (``test/plot.py``)

All functions read the same text-file schema the writers emit and save png
(or gif for frame sequences) files; matplotlib only -- safe to run headless.
No other module of the port imports this one: machines without matplotlib
run everything else.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _read_blocks(path: str, ragged: bool = False):
    """Read a blank-line-separated block file into a list of 2-D arrays, or --
    when rows have different lengths (param.txt mixes 4- and 8-parameter
    elements) -- a list of lists of 1-D arrays."""
    with open(path) as f:
        blocks = f.read().strip().split("\n\n")
    out = []
    for b in blocks:
        if not b.strip():
            continue
        rows = [np.array([float(v) for v in line.split()]) for line in b.splitlines()]
        out.append(rows if ragged else np.vstack(rows))
    return out


def plot_oracle_averages(averages_path: str, out_png: str) -> str:
    """<E>, <x>, <p>, populations vs time from an oracle's averages.txt
    (reference schrodinger_equation/plot scripts)."""
    data = np.loadtxt(averages_path)
    if data.ndim == 1:
        data = data[None, :]
    t = data[:, 0]
    fig, axes = plt.subplots(2, 2, figsize=(10, 7))
    axes[0, 0].plot(t, data[:, 1]); axes[0, 0].set_title("<E>")
    axes[0, 1].plot(t, data[:, 2]); axes[0, 1].set_title("<x>")
    axes[1, 0].plot(t, data[:, 3]); axes[1, 0].set_title("<p>")
    for s in range(4, data.shape[1]):
        axes[1, 1].plot(t, data[:, s], label=f"surface {s - 4}")
    axes[1, 1].set_title("populations"); axes[1, 1].legend()
    for ax in axes.ravel():
        ax.set_xlabel("t (a.u.)")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_averages(ave_path: str, out_png: str, num_pes: int = 2) -> str:
    """GPLE ave.txt: populations / <x> / <p> / energy, analytic vs MC
    (reference plot.py:214-272)."""
    data = np.loadtxt(ave_path)
    if data.ndim == 1:
        data = data[None, :]
    n = data.shape[0]
    t = np.arange(n)
    # per-surface block: [ppl_prm, x_prm, p_prm, NaN, ppl_mci, x_mci, p_mci, e_mci]
    w = 8
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    for s in range(num_pes):
        base = s * w
        axes[0, 0].plot(t, data[:, base + 0], label=f"prm {s}")
        axes[0, 0].plot(t, data[:, base + 4], "--", label=f"mci {s}")
        axes[0, 1].plot(t, data[:, base + 1], label=f"prm {s}")
        axes[0, 1].plot(t, data[:, base + 5], "--", label=f"mci {s}")
        axes[1, 0].plot(t, data[:, base + 7], label=f"mci {s}")
    axes[0, 0].set_title("population"); axes[0, 0].legend()
    axes[0, 1].set_title("<x>"); axes[0, 1].legend()
    axes[1, 0].set_title("energy (MC)"); axes[1, 0].legend()
    # totals + purity tail
    tot = num_pes * w
    axes[1, 1].plot(t, data[:, tot + 0], label="total pop (prm)")
    axes[1, 1].plot(t, data[:, tot + 4], "--", label="total pop (mci)")
    # purity totals sit at fixed offsets from the end: prm total then mci total
    axes[1, 1].plot(t, data[:, -(num_pes**2 + 1) - 1 - num_pes**2 + num_pes**2],
                    ":", label="purity (prm)")
    axes[1, 1].plot(t, data[:, -1], ":", label="purity (mci)")
    axes[1, 1].set_title("totals"); axes[1, 1].legend()
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_gple_log(log_path: str, out_png: str) -> str:
    """run.log diagnostics: wall time per output, MC steps, optimizer error
    (reference plot.py:124-211)."""
    rows = []
    with open(log_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 12:
                rows.append(parts)
    t = np.array([float(r[0]) for r in rows])
    wall = np.array([float(r[1]) for r in rows])
    steps = np.array([[float(r[2 + k]) for k in range(3)] for r in rows])
    # fields: t, wall, steps x3, disp x3, rescale x3, error, opt_steps, type,
    # timestamp ("%F %T %Z" = 3 tokens).  Locate error from the line END so
    # logs written before the rescales block became mandatory (3 fewer
    # columns) still parse.
    err = np.array([float(r[-6]) for r in rows])
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    axes[0].plot(t, wall); axes[0].set_title("wall time per output (s)")
    for k in range(3):
        axes[1].semilogy(t, np.maximum(steps[:, k], 1), label=f"element {k}")
    axes[1].set_title("MC steps"); axes[1].legend()
    axes[2].semilogy(t, np.maximum(err, 1e-300)); axes[2].set_title("optimizer error")
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_parameters(param_path: str, out_png: str) -> str:
    """Hyperparameter trajectories with bounds (reference plot.py:275-323)."""
    # each frame is one block of 9 ragged lines: 3 elements x (lb, param, ub)
    per_frame = _read_blocks(param_path, ragged=True)
    fig, axes = plt.subplots(1, 3, figsize=(13, 4))
    labels = ["rho00", "rho10", "rho11"]
    for elem in range(3):
        series = []
        for rows in per_frame:
            lb, param, ub = rows[elem * 3 : elem * 3 + 3]
            series.append(param)
        arr_len = min(len(s) for s in series)
        arr = np.array([s[:arr_len] for s in series])
        for j in range(arr.shape[1]):
            axes[elem].semilogy(np.abs(arr[:, j]) + 1e-300, label=f"p{j}")
        axes[elem].set_title(labels[elem])
        axes[elem].legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def plot_point_cloud(coord_path: str, value_path: str, out_png: str,
                     frame: int = -1) -> str:
    """Scatter of the sampled points colored by |rho| for one frame
    (reference plot.py:351-420)."""
    coords = _read_blocks(coord_path)[frame]
    values = _read_blocks(value_path)[frame]
    fig, axes = plt.subplots(1, coords.shape[0], figsize=(4 * coords.shape[0], 4))
    if coords.shape[0] == 1:
        axes = [axes]
    labels = ["rho00", "rho10", "rho11"]
    for k in range(coords.shape[0]):
        row = coords[k]
        half = row.shape[0] // 2
        x, p = row[:half], row[half:]
        vals = values[k]
        mag = np.hypot(vals[0::2], vals[1::2])
        sc = axes[k].scatter(x, p, c=mag, s=4, cmap="viridis")
        axes[k].set_title(labels[k] if k < 3 else str(k))
        fig.colorbar(sc, ax=axes[k])
    fig.tight_layout()
    fig.savefig(out_png, dpi=120)
    plt.close(fig)
    return out_png


def animate_point_cloud(coord_path: str, value_path: str, out_gif: str,
                        fps: int = 10, max_frames: Optional[int] = None) -> str:
    """Animated scatter of the sampled points colored by |rho|, one gif over
    all output frames (reference plot.py:423-449 'density'/'extra point'
    animations; PillowWriter replaces imagemagick)."""
    from matplotlib import animation

    coords = _read_blocks(coord_path)
    values = _read_blocks(value_path)
    n = min(len(coords), len(values), max_frames or len(coords))
    n_elem = coords[0].shape[0]
    labels = ["rho00", "rho10", "rho11"]
    fig, axes = plt.subplots(1, n_elem, figsize=(4 * n_elem, 4))
    if n_elem == 1:
        axes = [axes]
    xmin = min(float(c[k][: c[k].shape[0] // 2].min()) for c in coords[:n] for k in range(n_elem))
    xmax = max(float(c[k][: c[k].shape[0] // 2].max()) for c in coords[:n] for k in range(n_elem))
    scatters = []
    for k in range(n_elem):
        sc = axes[k].scatter([], [], c=[], s=4, cmap="viridis")
        axes[k].set_title(labels[k] if k < 3 else str(k))
        scatters.append(sc)

    def frame(i):
        for k in range(n_elem):
            row = coords[i][k]
            half = row.shape[0] // 2
            x, p = row[:half], row[half:]
            vals = values[i][k]
            mag = np.hypot(vals[0::2], vals[1::2])
            scatters[k].set_offsets(np.stack([x, p], axis=-1))
            scatters[k].set_array(mag)
            scatters[k].set_clim(0.0, max(float(mag.max()), 1e-300))
            axes[k].set_xlim(xmin, xmax)
            axes[k].set_ylim(float(p.min()) - 1, float(p.max()) + 1)
        return scatters

    ani = animation.FuncAnimation(fig, frame, n, interval=1000 // fps, blit=False)
    ani.save(out_gif, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_gif


def animate_phase_space(phase_path: str, n_grid: int, out_gif: str,
                        log_scale: bool = False, fps: int = 10,
                        max_frames: Optional[int] = None) -> str:
    """Animated heatmaps of the gridded GP prediction per element (reference
    plot.py:452-566 phase/variance animations; set ``log_scale`` for the
    variance file var.txt, which the reference renders in log scale)."""
    from matplotlib import animation

    blocks = _read_blocks(phase_path)
    n = min(len(blocks), max_frames or len(blocks))
    n_elem = blocks[0].shape[0]
    fig, axes = plt.subplots(1, n_elem, figsize=(4 * n_elem, 4))
    if n_elem == 1:
        axes = [axes]
    images = []
    for k in range(n_elem):
        im = axes[k].imshow(np.zeros((n_grid, n_grid)), origin="lower",
                            aspect="auto", cmap="RdBu_r")
        axes[k].set_title(f"element {k}")
        images.append(im)

    def grid_of(b, k):
        row = b[k]
        re = row[0::2] if row.shape[0] == 2 * n_grid * n_grid else row
        g = re.reshape(n_grid, n_grid).T
        return np.log10(np.abs(g) + 1e-300) if log_scale else g

    def frame(i):
        for k in range(n_elem):
            g = grid_of(blocks[i], k)
            images[k].set_data(g)
            vmax = max(float(np.abs(g).max()), 1e-300)
            images[k].set_clim(-vmax if not log_scale else g.min(), vmax if not log_scale else g.max())
        return images

    ani = animation.FuncAnimation(fig, frame, n, interval=1000 // fps, blit=False)
    ani.save(out_gif, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_gif


def animate_psi(outdir: str, out_gif: str, fps: int = 10,
                max_frames: Optional[int] = None) -> str:
    """Animated |psi|^2 per surface from a DVR run's x.txt/t.txt/psi.txt
    (reference schrodinger_equation/plot_psi.py)."""
    from matplotlib import animation

    x = np.loadtxt(os.path.join(outdir, "x.txt"))
    t = np.atleast_1d(np.loadtxt(os.path.join(outdir, "t.txt")))
    psi = np.loadtxt(os.path.join(outdir, "psi.txt"))
    if psi.ndim == 1:
        psi = psi[None, :]
    n_grid = x.size
    n_pes = psi.shape[1] // (2 * n_grid)
    n = min(len(t), psi.shape[0], max_frames or len(t))
    fig, ax = plt.subplots(figsize=(7, 4))
    lines = [ax.plot([], [], label=f"surface {s}")[0] for s in range(n_pes)]
    ax.set_xlim(float(x.min()), float(x.max()))
    ax.legend()

    def frame(i):
        row = psi[i]
        ymax = 1e-300
        for s in range(n_pes):
            seg = row[2 * s * n_grid : 2 * (s + 1) * n_grid]
            dens = seg[0::2] ** 2 + seg[1::2] ** 2
            lines[s].set_data(x, dens)
            ymax = max(ymax, float(dens.max()))
        ax.set_ylim(0.0, 1.1 * ymax)
        ax.set_title(f"t = {t[i]:g}")
        return lines

    ani = animation.FuncAnimation(fig, frame, n, interval=1000 // fps, blit=False)
    ani.save(out_gif, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_gif


def plot_phase_space_frames(phase_path: str, n_grid: int, outdir: str,
                            max_frames: Optional[int] = 4) -> List[str]:
    """Contour frames of the gridded GP prediction (reference plot.py:423-566
    renders these as gif animations -- see :func:`animate_phase_space`; this
    emits per-frame pngs)."""
    os.makedirs(outdir, exist_ok=True)
    blocks = _read_blocks(phase_path)
    outputs = []
    for i, b in enumerate(blocks[: max_frames or len(blocks)]):
        fig, axes = plt.subplots(1, b.shape[0], figsize=(4 * b.shape[0], 4))
        if b.shape[0] == 1:
            axes = [axes]
        for k in range(b.shape[0]):
            re = b[k][0::2].reshape(n_grid, n_grid)
            axes[k].imshow(re.T, origin="lower", aspect="auto", cmap="RdBu_r")
            axes[k].set_title(f"element {k}")
        path = os.path.join(outdir, f"phase_{i:04d}.png")
        fig.tight_layout()
        fig.savefig(path, dpi=100)
        plt.close(fig)
        outputs.append(path)
    return outputs
