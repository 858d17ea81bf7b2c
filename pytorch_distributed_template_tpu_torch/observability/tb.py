"""TensorBoard facade: explicit methods, graceful degradation (a copy of
the JAX package's ``observability/tb.py``, with the same backend order).

Mode-suffixed scalar tags for train/valid separation, a ``steps_per_sec``
scalar derived from ``set_step`` wall-clock deltas, and a silent no-op when
TB is disabled or no backend imports. Every supported ``add_*`` is a real
method, so typos raise immediately and ``add_embedding`` takes
TensorBoard's own argument order.
"""
from __future__ import annotations

import importlib
import time


class TensorboardWriter:
    """Rank-0 metrics sink. All methods no-op when ``enabled`` is False or
    no TB backend imports, so call sites never need to guard."""

    TB_MODULES = ("torch.utils.tensorboard", "tensorboardX")

    def __init__(self, log_dir, logger, enabled: bool):
        self.writer = None
        self.selected_module = ""
        if enabled:
            for module in self.TB_MODULES:
                try:
                    self.writer = importlib.import_module(
                        module
                    ).SummaryWriter(str(log_dir))
                    self.selected_module = module
                    break
                except ImportError:
                    continue
            if self.writer is None:
                logger.warning(
                    "trainer.tensorboard is enabled but no backend could "
                    "be imported (tried %s); metrics will not be recorded. "
                    "Install tensorboard/tensorboardX or set "
                    "trainer.tensorboard to false.",
                    ", ".join(self.TB_MODULES),
                )
        self.step = 0
        self.mode = ""
        self._last_step_time = time.monotonic()

    def set_step(self, step: int, mode: str = "train") -> None:
        """Advance the global step; non-zero steps also record the
        wall-clock-derived ``steps_per_sec`` scalar."""
        self.mode = mode
        self.step = step
        now = time.monotonic()
        if step == 0:
            self._last_step_time = now
        else:
            self.add_scalar(
                "steps_per_sec", 1.0 / max(now - self._last_step_time, 1e-12)
            )
            self._last_step_time = now

    def _emit(self, method: str, tag: str, *args, mode_tag: bool = True,
              **kwargs):
        if self.writer is None:
            return
        fn = getattr(self.writer, method, None)
        if fn is None:  # backend lacks this method (old tensorboardX etc.)
            return
        if mode_tag and self.mode:
            tag = f"{tag}/{self.mode}"
        # global_step always as a keyword: its positional slot differs
        # across TB methods.
        kwargs.setdefault("global_step", self.step)
        fn(tag, *args, **kwargs)

    # -- scalars / text ---------------------------------------------------
    def add_scalar(self, tag, value, **kwargs):
        self._emit("add_scalar", tag, value, **kwargs)

    def add_scalars(self, tag, value_dict, **kwargs):
        self._emit("add_scalars", tag, value_dict, **kwargs)

    def add_text(self, tag, text, **kwargs):
        self._emit("add_text", tag, text, **kwargs)

    # -- media ------------------------------------------------------------
    def add_image(self, tag, img, **kwargs):
        self._emit("add_image", tag, img, **kwargs)

    def add_images(self, tag, imgs, **kwargs):
        self._emit("add_images", tag, imgs, **kwargs)

    def add_audio(self, tag, snd, **kwargs):
        self._emit("add_audio", tag, snd, **kwargs)

    # -- distributions (tags stay global: the same weights are logged from
    # train and valid phases and must land in one chart) -------------------
    def add_histogram(self, tag, values, **kwargs):
        self._emit("add_histogram", tag, values, mode_tag=False, **kwargs)

    def add_pr_curve(self, tag, labels, predictions, **kwargs):
        self._emit("add_pr_curve", tag, labels, predictions, **kwargs)

    def add_embedding(self, mat, metadata=None, label_img=None,
                      tag="default", **kwargs):
        if self.writer is None:
            return
        fn = getattr(self.writer, "add_embedding", None)
        if fn is None:
            return
        kwargs.setdefault("global_step", self.step)
        fn(mat, metadata=metadata, label_img=label_img, tag=tag, **kwargs)

    # -- lifecycle --------------------------------------------------------
    def flush(self):
        if self.writer is not None:
            self.writer.flush()

    def close(self):
        if self.writer is not None:
            self.writer.close()
