"""Spectrogram figures for validation (port of
``megatts2_tpu/utils/plotting.py``; reference ``utils/utils.py:55-84``).

A target / output mel pair becomes a PNG when matplotlib imports (the Agg
backend, headless), and an ``.npz`` pair (``target``, ``output``) when it
does not: the card's machine has no matplotlib.  matplotlib is imported at
the first figure, not with this module.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    from matplotlib import pyplot

    return pyplot


def plot_spectrogram_to_numpy(spec_target: np.ndarray,
                              spec_output: np.ndarray) -> Optional[np.ndarray]:
    """(n_mels, T) target and output → an (H, W, 3) uint8 image, or None
    without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(12, 12))
    for ax, spec, title in ((ax1, spec_target, "Target"), (ax2, spec_output, "Output")):
        ax.set_title(title)
        im = ax.imshow(np.asarray(spec, np.float32), aspect="auto", origin="lower",
                       interpolation="none")
        fig.colorbar(im, ax=ax)
        ax.set_xlabel("Frames")
        ax.set_ylabel("Channels")
    fig.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return data


def save_spectrogram_plot(path: str, spec_target: np.ndarray, spec_output: np.ndarray) -> str:
    """Save the comparison: ``path + ".png"`` with matplotlib, else
    ``path + ".npz"``.  Returns the written path."""
    img = plot_spectrogram_to_numpy(spec_target, spec_output)
    if img is None:
        path += ".npz"
        np.savez(path, target=spec_target, output=spec_output)
        return path
    from matplotlib import image

    if not path.endswith(".png"):
        path += ".png"
    image.imsave(path, img)
    return path
