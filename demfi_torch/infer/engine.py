"""Inference engine: t-batched whole-window forward + tiled big-frame path.

Departures from the reference inference driver, kept from the JAX engine:

1. **t-batching.** The t-independent Stage I context (RDN backbone +
   FAC-FB) runs once per window and all M-1 instants go through
   ``synthesize`` as one batch.
2. **Window batching.** ``forward_windows`` batches N windows in one
   call (an N*(M-1) synthesize batch).
3. **Tiling.** For frames too large for device memory, the reference's
   reflect-pad + halo + trim + stitch semantics are kept exactly.
4. **Dispatch / fetch.** ``dispatch_windows`` enqueues one batch of
   windows on a CUDA stream of the engine (host-to-device copy, forward,
   device-to-host copies into pinned buffers) and returns a handle;
   ``fetch_windows`` waits for it. A caller that dispatches batch N+1
   before it fetches batch N keeps the device busy while it works on
   batch N's results on the host.

The public surface keeps the JAX engine's layout: frames come in as numpy
[N, 4, H, W, 3] (BGR in [-1, 1], order B0, B1, B-1, B2) and
``WindowResult`` fields come out as NHWC numpy with a leading t axis.
Inside, the model works on NCHW tensors.

Float32 parity: the engine turns TF32 off for cuDNN convolutions and
cuBLAS matmuls, process-wide (:func:`demfi_torch.disable_tf32`, which
the train step calls too).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from demfi_torch import disable_tf32, nchw_to_nhwc, resolve_device
from demfi_torch.models.demfi import DeMFINet

# Device bytes per pixel-instant of a float32 window batch: the peak
# memory allocated above the weights while serving one 352x640 x8 window
# (7 instants), over 352*640*7. Measured by chip_smoke.py on an NVIDIA
# H100 80GB HBM3 at its 700 W power limit: 19,857 B. The t-chunk cap is
# the free device memory (torch.cuda.mem_get_info) times 0.78 over this.
BYTES_PER_PIXEL_INSTANT = 19_857
_MEMORY_SHARE = 0.78


@dataclasses.dataclass
class WindowResult:
    """Outputs for one 4-frame window at its M-1 t-values (numpy NHWC,
    leading t axis; t-independent fields broadcast over t)."""
    s0_prime: np.ndarray   # [T,H,W,3]
    s1_prime: np.ndarray
    st_prime: np.ndarray
    s0_final: np.ndarray   # [T,H,W,3] (last boosting iteration)
    s1_final: np.ndarray
    st_final: np.ndarray
    flow_init: np.ndarray  # [T,H,W,4]
    flow_final: np.ndarray
    occ0_init: np.ndarray  # [T,H,W,1]
    occ0_final: np.ndarray
    ovlp: np.ndarray       # [T,H,W,3]
    blend_w0: np.ndarray   # [T,H,W,1] FGAC gate maps
    blend_w1: np.ndarray
    diff_10: np.ndarray    # [T,H,W,1] FGAC difference maps
    diff_01: np.ndarray
    # visualization internals (zeros unless the model was built with
    # viz_internals): normalised source key / init ref key / aggregated
    # E_s / bolstered per direction, plus the bidirectional flows
    fgac_src_10: np.ndarray = None   # [T,H,W,1]
    fgac_ref_10: np.ndarray = None
    fgac_warp_10: np.ndarray = None
    fgac_fcw_10: np.ndarray = None
    fgac_src_01: np.ndarray = None
    fgac_ref_01: np.ndarray = None
    fgac_warp_01: np.ndarray = None
    fgac_fcw_01: np.ndarray = None
    flow_01: np.ndarray = None       # [T,H,W,2]
    flow_10: np.ndarray = None


_FIELDS = [f.name for f in dataclasses.fields(WindowResult)]


def _field_channels(name: str) -> int:
    """Channel count of each WindowResult field (zero-fill + canvases)."""
    return {"flow_init": 4, "flow_final": 4, "occ0_init": 1,
            "occ0_final": 1, "blend_w0": 1, "blend_w1": 1,
            "diff_10": 1, "diff_01": 1, "flow_01": 2, "flow_10": 2,
            }.get(name, 1 if name.startswith("fgac_") else 3)


def _pad_reflect_to_multiple(frames: np.ndarray, m: int
                             ) -> Tuple[np.ndarray, int, int]:
    """Reflect-pad H, W (bottom/right) to multiples of m. frames:
    [B,T,H,W,C]."""
    h, w = frames.shape[2], frames.shape[3]
    ph = (-h) % m
    pw = (-w) % m
    if ph or pw:
        frames = np.pad(frames, ((0, 0), (0, 0), (0, ph), (0, pw), (0, 0)),
                        mode="reflect")
    return frames, h, w


def _tile_bounds(pb: int, h: int, w: int, ph: int, sh: int, pw: int, sw: int):
    """The reference's get_HW_boundary: tile (ph, pw) plus its halo."""
    h_lo = max(ph * sh - pb, 0)
    h_hi = min((ph + 1) * sh + pb, h)
    w_lo = max(pw * sw - pb, 0)
    w_hi = min((pw + 1) * sw + pb, w)
    return h_lo, h_hi, w_lo, w_hi


def _trim(img: np.ndarray, pb: int, h: int, w: int, ph: int, sh: int,
          pw: int, sw: int) -> np.ndarray:
    """The reference's trim_patch_boundary, on [..., H, W, C]."""
    if pb == 0:
        return img
    if ph * sh >= pb:
        img = img[..., pb:, :, :]
    if (ph + 1) * sh + pb <= h:
        img = img[..., :-pb, :, :]
    if pw * sw >= pb:
        img = img[..., :, pb:, :]
    if (pw + 1) * sw + pb <= w:
        img = img[..., :, :-pb, :]
    return img


@dataclasses.dataclass
class _Pending:
    """One dispatched device batch: the selected fields as NHWC host
    tensors (pinned on the card), the event recorded after the last copy
    (None on the CPU, where the work is already done), the events that
    bracket the batch on the engine's stream."""
    host: dict
    n: int
    m: int
    done: Optional["torch.cuda.Event"] = None
    start: Optional["torch.cuda.Event"] = None


def _concat_results(parts: Sequence[WindowResult]) -> WindowResult:
    return WindowResult(**{k: np.concatenate([getattr(p, k) for p in parts])
                           for k in _FIELDS})


def _crop(r: WindowResult, h: int, w: int) -> WindowResult:
    return WindowResult(**{k: getattr(r, k)[:, :h, :w, :] for k in _FIELDS})


class InferenceEngine:
    """Whole-window inference for a fixed model and its weights."""

    def __init__(self, model: DeMFINet, num_update: int,
                 t_chunk: Optional[int] = None, fetch: str = "full",
                 device=None):
        """model: a DeMFINet (moved to ``device``, the GPU unless the
        caller passes device="cpu").

        t_chunk: cap on t-values per device batch; None derives it from
        the free device memory (no cap on the CPU).

        fetch: which WindowResult tensors are copied to the host. "full"
        copies every field; "images" only the six output frames (primes
        and last-iteration finals) and zero-fills the rest host-side."""
        if fetch not in ("full", "images"):
            raise ValueError(f"fetch must be 'full' or 'images', got {fetch!r}")
        self.device = resolve_device(device)
        disable_tf32()
        self.model = model.to(self.device).eval()
        self.num_update = num_update
        self.t_chunk = t_chunk
        self.fetch = fetch
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        # windows that went through dispatch_windows, and the seconds
        # between the CUDA events that bracket each dispatched batch on
        # the engine's stream (stays 0 on the CPU). The span holds the
        # gaps in which the stream waits for the host's next launch, so
        # it bounds the device's busy time from above.
        self.dispatched_windows = 0
        self.dispatched_stream_seconds = 0.0

    # -------------------------------------------------------------- core
    @torch.inference_mode()
    def _forward(self, frames: torch.Tensor, ts: torch.Tensor) -> dict:
        """frames [N,4,H,W,3], ts [N,M] (host tensors; pinned ones are
        copied without the host waiting for the stream) -> dict of NHWC
        device tensors with batch N*M: the fields that ``fetch``
        selects."""
        n, m = ts.shape
        model = self.model
        x = frames.to(self.device, non_blocking=True).permute(
            0, 1, 4, 2, 3).contiguous()
        t = ts.to(self.device, non_blocking=True).reshape(n * m, 1)
        ctx = model.extract(x).repeat(m)
        out = model.synthesize(ctx, t, self.num_update)
        last = out.s0_final.shape[0] > 0
        sel = dict(
            s0_prime=out.s0_prime, s1_prime=out.s1_prime,
            st_prime=out.st_prime,
            s0_final=out.s0_final[-1] if last else out.s0_prime,
            s1_final=out.s1_final[-1] if last else out.s1_prime,
            st_final=out.st_final[-1] if last else out.st_prime)
        if self.fetch == "full":
            sel.update(
                flow_init=out.flow_preds[0], flow_final=out.flow_preds[-1],
                occ0_init=out.occ0_preds[0], occ0_final=out.occ0_preds[-1],
                ovlp=out.ovlp_b0b1,
                blend_w0=out.blend_weights[0], blend_w1=out.blend_weights[1],
                diff_10=out.diff_maps[0], diff_01=out.diff_maps[1])
            if out.viz_stacks:
                (s10, s01, vflows) = out.viz_stacks
                sel.update(
                    fgac_src_10=s10[0], fgac_ref_10=s10[1],
                    fgac_warp_10=s10[2], fgac_fcw_10=s10[3],
                    fgac_src_01=s01[0], fgac_ref_01=s01[1],
                    fgac_warp_01=s01[2], fgac_fcw_01=s01[3],
                    flow_01=vflows[0], flow_10=vflows[1])
        return {k: nchw_to_nhwc(v) for k, v in sel.items()}

    @staticmethod
    def _results(out: dict, n: int, m: int) -> List[WindowResult]:
        """NHWC numpy fields with batch n*m -> per-window results.
        Fields not fetched (fetch="images", or a model built without
        viz_internals) zero-fill host-side."""
        shp = out["st_prime"].shape[:-1]
        for k in _FIELDS:
            if k not in out:
                out[k] = np.zeros(shp + (_field_channels(k),), np.float32)
        return [WindowResult(**{k: out[k].reshape((n, m) + out[k].shape[1:])[i]
                                for k in _FIELDS})
                for i in range(n)]

    @staticmethod
    def _host_inputs(frames: np.ndarray, ts: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.from_numpy(np.ascontiguousarray(frames, np.float32)),
                torch.from_numpy(np.ascontiguousarray(ts, np.float32)))

    def _run(self, frames: np.ndarray, ts: np.ndarray) -> List[WindowResult]:
        """frames [N,4,H,W,3], ts [N,M] -> per-window results."""
        n, m = ts.shape
        out = self._forward(*self._host_inputs(frames, ts))
        return self._results({k: v.cpu().numpy() for k, v in out.items()},
                             n, m)

    def _dispatch(self, frames: np.ndarray, ts: np.ndarray) -> _Pending:
        """Enqueue one device batch on the engine's stream: the input
        copies from pinned buffers (a copy from pageable memory would
        make the host wait for the stream, and with it for the batch
        before), the forward, and the copies of the selected fields into
        pinned host buffers, all asynchronous, then an event. The stream
        is entered here, not by the caller:
        ``torch.cuda.current_stream`` is per thread, and the evaluation
        loop dispatches from a worker thread.

        The pinned buffers are allocated per batch and go back to
        PyTorch's pinned-memory cache when the results built on them are
        dropped (in "images" mode 6 fields of 3 channels; in "full" mode
        every field). On the CPU the forward runs here and ``_fetch``
        hands it back."""
        n, m = ts.shape
        frames_t, ts_t = self._host_inputs(frames, ts)
        if self._stream is None:
            return _Pending(self._forward(frames_t, ts_t), n, m)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record()
            host = {}
            for k, v in self._forward(frames_t.pin_memory(),
                                      ts_t.pin_memory()).items():
                host[k] = torch.empty(v.shape, dtype=v.dtype,
                                      pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            done.record()
        return _Pending(host, n, m, done, start)

    def _fetch(self, pending: _Pending) -> List[WindowResult]:
        """Wait for a dispatched batch and build its results."""
        if pending.done is not None:
            pending.done.synchronize()
            self.dispatched_stream_seconds += \
                pending.start.elapsed_time(pending.done) / 1e3
        return self._results({k: v.numpy() for k, v in pending.host.items()},
                             pending.n, pending.m)

    def _pixel_instant_budget(self) -> Optional[int]:
        """Pixel-instants one device batch may hold; None = no cap."""
        if self.device.type != "cuda":
            return None
        # free on the device, plus what PyTorch's allocator holds unused
        # from earlier windows
        free, _ = torch.cuda.mem_get_info(self.device)
        free += (torch.cuda.memory_reserved(self.device)
                 - torch.cuda.memory_allocated(self.device))
        return int(free * _MEMORY_SHARE / BYTES_PER_PIXEL_INSTANT)

    def _effective_t_chunk(self, h, w, m, test_patch=(1, 1), n_windows=1):
        """User cap if given, else the memory-derived one (per-tile pixels
        when the tiled path will split the frame; N windows multiply the
        pixels per instant by N). Returns 0 when even a single instant of
        the window batch exceeds the budget, None for no chunking."""
        if self.t_chunk:
            return self.t_chunk
        budget = self._pixel_instant_budget()
        if budget is None:
            return None
        px = (h // test_patch[0]) * (w // test_patch[1]) * n_windows
        cap = budget // max(px, 1)
        if cap < 1:
            return 0 if n_windows > 1 else 1
        return cap if cap < m else None

    def forward_windows(self, frames: np.ndarray, ts: np.ndarray,
                        patch_boundary: int = 32) -> List[WindowResult]:
        """Batched untiled inference: frames [N,4,H,W,3], ts [N,M].

        The t axis is chunked under the memory budget scaled by the window
        count; if even one instant of the N-window batch exceeds it the
        windows run one by one through ``forward_window``. Frame dims are
        reflect-padded to multiples of ``patch_boundary`` and the outputs
        trimmed back."""
        ts = np.asarray(ts, np.float32)
        n, m = ts.shape
        frames, ori_h, ori_w = _pad_reflect_to_multiple(
            frames, max(patch_boundary, 1))
        chunk = self._effective_t_chunk(frames.shape[2], frames.shape[3],
                                        m, n_windows=n)
        if chunk == 0:
            return [self.forward_window(frames[i:i + 1, :, :ori_h, :ori_w],
                                        ts[i], patch_boundary=patch_boundary)
                    for i in range(n)]
        if chunk and m > chunk:
            parts = [self._run(frames, ts[:, i:i + chunk])
                     for i in range(0, m, chunk)]
            return [_crop(_concat_results([p[wi] for p in parts]),
                          ori_h, ori_w) for wi in range(n)]
        return [_crop(r, ori_h, ori_w) for r in self._run(frames, ts)]

    def dispatch_windows(self, frames: np.ndarray, ts: np.ndarray,
                         patch_boundary: int = 32
                         ) -> Optional[Tuple[List[_Pending], int, int]]:
        """Asynchronous half of ``forward_windows``: enqueue the device
        work and return a handle for :meth:`fetch_windows`, or ``None``
        when this call cannot be pipelined (even one instant of the
        batch exceeds the memory budget, so the windows must go through
        ``forward_window``'s per-tile host logic); the caller then uses
        ``forward_window`` or ``forward_windows`` directly."""
        ts = np.asarray(ts, np.float32)
        n, m = ts.shape
        frames, ori_h, ori_w = _pad_reflect_to_multiple(
            frames, max(patch_boundary, 1))
        chunk = self._effective_t_chunk(frames.shape[2], frames.shape[3],
                                        m, n_windows=n)
        if chunk == 0:
            return None
        step = chunk if chunk and m > chunk else m
        # t-chunked: every chunk is enqueued now and runs in stream order
        pendings = [self._dispatch(frames, ts[:, i:i + step])
                    for i in range(0, m, step)]
        self.dispatched_windows += n
        return pendings, ori_h, ori_w

    def fetch_windows(self, handle) -> List[WindowResult]:
        """Blocking half of ``forward_windows`` for a
        :meth:`dispatch_windows` handle: the same results, bit for bit."""
        pendings, ori_h, ori_w = handle
        parts = [self._fetch(p) for p in pendings]
        if len(parts) == 1:
            return [_crop(r, ori_h, ori_w) for r in parts[0]]
        return [_crop(_concat_results([p[wi] for p in parts]), ori_h, ori_w)
                for wi in range(len(parts[0]))]

    def forward_window(self, frames: np.ndarray, ts: Sequence[float],
                       test_patch: Tuple[int, int] = (1, 1),
                       patch_boundary: int = 32) -> WindowResult:
        """Full-resolution single-window inference with the reference's
        pad/tile/halo/trim/stitch semantics, batching all t per tile.

        frames: [1,4,H,W,3] float32 BGR in [-1,1] (order B0,B1,B-1,B2).
        """
        ts = np.asarray(ts, np.float32)
        chunk = self._effective_t_chunk(frames.shape[2], frames.shape[3],
                                        len(ts), test_patch)
        if chunk and len(ts) > chunk:
            return _concat_results([
                self.forward_window(frames, ts[i:i + chunk], test_patch,
                                    patch_boundary)
                for i in range(0, len(ts), chunk)])

        frames, ori_h, ori_w = _pad_reflect_to_multiple(frames, patch_boundary)
        new_h, new_w = frames.shape[2], frames.shape[3]
        n_ph, n_pw = test_patch
        sh, sw = new_h // n_ph, new_w // n_pw
        m = len(ts)

        if tuple(test_patch) == (1, 1):
            return _crop(self._run(frames, ts[None])[0], ori_h, ori_w)

        fields = {k: np.zeros((m, new_h, new_w, _field_channels(k)),
                              np.float32) for k in _FIELDS}
        # group same-shape tiles (interior tiles share a shape) and run
        # each group as one batch
        groups: dict = {}
        for ph in range(n_ph):
            for pw in range(n_pw):
                h_lo, h_hi, w_lo, w_hi = _tile_bounds(
                    patch_boundary, new_h, new_w, ph, sh, pw, sw)
                tile = frames[:, :, h_lo:h_hi, w_lo:w_hi, :]
                groups.setdefault(tile.shape, []).append(((ph, pw), tile))
        budget = self._pixel_instant_budget()
        for shape, group in groups.items():
            # bound the group batch by the memory budget too: tiles x
            # instants x tile pixels is the real footprint
            per_call = (len(group) if budget is None else
                        max(1, budget // max(m * shape[2] * shape[3], 1)))
            results: List[WindowResult] = []
            for i in range(0, len(group), per_call):
                sub = group[i:i + per_call]
                batch = np.concatenate([t for _, t in sub], axis=0)
                results.extend(self._run(batch, np.tile(ts[None],
                                                        (len(sub), 1))))
            for ((ph, pw), _), res in zip(group, results):
                for name, canvas in fields.items():
                    canvas[:, ph * sh:(ph + 1) * sh,
                           pw * sw:(pw + 1) * sw, :] = _trim(
                        getattr(res, name), patch_boundary,
                        new_h, new_w, ph, sh, pw, sw)
        return WindowResult(**{k: v[:, :ori_h, :ori_w, :]
                               for k, v in fields.items()})
