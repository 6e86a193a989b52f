"""Inputs and weights of a run, made on its device from ``--seed``.

Frames follow the BIN blur of Adobe240 and GoPro (DeMFI's training and
test data): sharp 240 fps frames of smooth textures in motion, each
blurry 30 fps frame the mean of the 11 sharp frames around it, blurry
frames 8 sharp frames apart. A scene is a background texture translating
at one velocity and three soft-edged discs with textures of their own,
each at its own velocity, so that the flows are piecewise smooth and the
discs occlude the background. Every speed is at most ``max_px`` pixels
a sharp frame (24 px a blurry interval at 3). Textures are sums of
cosines with wavelengths of 12 to 200 pixels, amplitudes rising with the
wavelength and summing to 0.9 a channel, so every value lies in
[-0.9, 0.9], as frames scaled to [-1, 1] do. A sharp frame is evaluated
at any real time s (in sharp frames), so nothing is resampled.

Weights: every parameter of the model from one normal draw (Xavier's
scale: the program's own initialisation) and every bias from one uniform
draw (PyTorch's default range), float32, the dtype the program keeps its
parameters in. Their keys are the published model's.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

N_WAVES = 12         # cosines a texture
N_DISCS = 3
SHARP_PER_BLUR = 11  # sharp frames averaged into one blurry frame
STRIDE = 8           # sharp frames between two blurry frames


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a seed."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 7919 + stream) % (2 ** 63))


def make_weights(shapes: List[tuple], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """A state dict for (name, shape) pairs: weights N(0, 2 / (fan_in +
    fan_out)), biases U(-1/sqrt(fan_in), 1/sqrt(fan_in)), each kind from
    one draw of a generator on ``device``."""
    gen = generator(seed, device, 0)
    weights = [(k, s) for k, s in shapes if len(s) > 1]
    biases = [(k, s) for k, s in shapes if len(s) == 1]
    flat_w = torch.randn(sum(math.prod(s) for _, s in weights),
                         generator=gen, device=device)
    flat_b = torch.rand(sum(math.prod(s) for _, s in biases),
                        generator=gen, device=device) * 2 - 1
    out: Dict[str, torch.Tensor] = {}
    at, fan_in = 0, {}
    for k, s in weights:
        rf = math.prod(s[2:])
        fan_in[k.rsplit(".", 1)[0]] = s[1] * rf
        std = math.sqrt(2.0 / (s[1] * rf + s[0] * rf))
        out[k] = flat_w[at:at + math.prod(s)].view(s) * std
        at += math.prod(s)
    at = 0
    for k, s in biases:
        out[k] = flat_b[at:at + s[0]] / math.sqrt(fan_in[k.rsplit(".", 1)[0]])
        at += s[0]
    return {k: out[k] for k, _ in shapes}


def _textures(n: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """n textures: frequencies (cycles a pixel) [n, K, 2], amplitudes and
    phases [n, 3, K]."""
    lam = torch.exp(math.log(12.0) + torch.rand(n, N_WAVES, generator=gen,
                                                device=device)
                    * math.log(200.0 / 12.0))
    ang = torch.rand(n, N_WAVES, generator=gen, device=device) * 2 * math.pi
    freq = torch.stack([torch.cos(ang), torch.sin(ang)], -1) / lam[..., None]
    amp = lam[:, None, :] * (0.5 + torch.rand(n, 3, N_WAVES, generator=gen,
                                              device=device))
    amp = 0.9 * amp / amp.sum(-1, keepdim=True)
    phase = torch.rand(n, 3, N_WAVES, generator=gen, device=device) \
        * 2 * math.pi
    return {"freq": freq, "amp": amp, "phase": phase}


def _velocity(shape, max_px: float, gen, device) -> torch.Tensor:
    """Velocities [*shape, 2] of speed in [max_px / 6, max_px]."""
    speed = max_px * (1 + 5 * torch.rand(shape, generator=gen,
                                         device=device)) / 6
    ang = torch.rand(shape, generator=gen, device=device) * 2 * math.pi
    return torch.stack([torch.cos(ang), torch.sin(ang)], -1) * speed[..., None]


def make_scenes(n: int, h: int, w: int, max_px: float, gen, device) -> dict:
    """Parameters of n scenes of h x w pixels."""
    r = (0.12 + 0.16 * torch.rand(n, N_DISCS, generator=gen, device=device)) \
        * min(h, w)
    return {"bg": _textures(n, gen, device),
            "bg_v": _velocity((n,), max_px, gen, device),
            "bg_o": torch.rand(n, 2, generator=gen, device=device) * 1000,
            "fg": _textures(n * N_DISCS, gen, device),
            "fg_v": _velocity((n, N_DISCS), max_px, gen, device),
            "fg_o": torch.rand(n, N_DISCS, 2, generator=gen, device=device)
            * torch.tensor([w, h], device=device),
            "fg_r": r, "h": h, "w": w}


def _texture_at(tex: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Textures [n] on the grid x [n, S, W], y [n, S, H] (pixel
    coordinates in each texture's frame): [n, S, 3, H, W]. Separable:
    cos(a + b) = cos a cos b - sin a sin b, so one product a channel."""
    fx, fy = tex["freq"][..., 0], tex["freq"][..., 1]          # [n, K]
    a = 2 * math.pi * fx[:, None, :, None] * x[:, :, None, :]   # [n,S,K,W]
    a = a[:, :, None] + tex["phase"][:, None, :, :, None]       # [n,S,3,K,W]
    b = 2 * math.pi * fy[:, None, :, None] * y[:, :, None, :]   # [n,S,K,H]
    amp = tex["amp"][:, None, :, :, None]                       # [n,1,3,K,1]
    left = torch.cat([torch.cos(b)[:, :, None] * amp,
                      torch.sin(b)[:, :, None] * amp], 3)       # [n,S,3,2K,H]
    right = torch.cat([torch.cos(a), -torch.sin(a)], 3)         # [n,S,3,2K,W]
    return torch.einsum("nsckh,nsckw->nschw", left, right)


def render(sc: dict, s: torch.Tensor) -> torch.Tensor:
    """Sharp frames of the scenes at times s [S] (sharp frames):
    [n, S, 3, H, W] float32."""
    h, w = sc["h"], sc["w"]
    dev = s.device
    n = sc["bg_v"].shape[0]
    gx = torch.arange(w, dtype=torch.float32, device=dev)
    gy = torch.arange(h, dtype=torch.float32, device=dev)
    pos = sc["bg_o"][:, None] + sc["bg_v"][:, None] * s[None, :, None]
    img = _texture_at(sc["bg"], gx - pos[..., :1], gy - pos[..., 1:])
    for d in range(N_DISCS):
        r = sc["fg_r"][:, d]                                    # [n]
        period = torch.stack([w + 2 * r + 8, h + 2 * r + 8], -1)
        c = sc["fg_o"][:, d, None] + sc["fg_v"][:, d, None] * s[None, :, None]
        c = torch.remainder(c + (r[:, None, None] + 4), period[:, None]) \
            - (r[:, None, None] + 4)                            # [n, S, 2]
        dx = gx - c[..., :1]                                    # [n, S, W]
        dy = gy - c[..., 1:]                                    # [n, S, H]
        dist = torch.sqrt(dx[:, :, None, :] ** 2 + dy[:, :, :, None] ** 2)
        alpha = torch.sigmoid((r[:, None, None, None] - dist) / 1.5)
        tex = {k: v.view(n, N_DISCS, *v.shape[1:])[:, d]
               for k, v in sc["fg"].items()}
        img = img + alpha[:, :, None] * (_texture_at(tex, dx, dy) - img)
    return img


def blurry(sc: dict, centres: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """Blurry frames [n, J, 3, H, W] centred at sharp times ``centres``
    [J]: each the mean of the 11 sharp frames around its centre."""
    offs = torch.arange(SHARP_PER_BLUR, device=centres.device,
                        dtype=torch.float32) - SHARP_PER_BLUR // 2
    parts = []
    for i in range(0, centres.numel(), chunk):
        s = (centres[i:i + chunk, None] + offs).reshape(-1)
        f = render(sc, s)
        parts.append(f.view(f.shape[0], -1, SHARP_PER_BLUR,
                            *f.shape[2:]).mean(2))
    return torch.cat(parts, 1)


def serve_clip(seed: int, n_frames: int, h: int, w: int, max_px: float,
               device) -> np.ndarray:
    """A clip of n_frames blurry frames of one scene, [n_frames, H, W, 3]
    float32 on the host (the serving engine's layout)."""
    gen = generator(seed, device, 1)
    sc = make_scenes(1, h, w, max_px, gen, device)
    centres = torch.arange(n_frames, device=device,
                           dtype=torch.float32) * STRIDE
    out = np.empty((n_frames, h, w, 3), np.float32)
    step = max(1, (1 << 22) // (h * w))       # ~0.5 GB a sharp-frame batch
    for i in range(0, n_frames, step):
        f = blurry(sc, centres[i:i + step])[0]
        out[i:i + f.shape[0]] = f.permute(0, 2, 3, 1).cpu().numpy()
    return out


def window_frames(clip: np.ndarray, i: int) -> np.ndarray:
    """Window i of a clip: blurry frames i .. i+3 in the model's order
    (B0, B1, B-1, B2), [1, 4, H, W, 3]; windows past the clip's end
    cycle."""
    n = clip.shape[0] - 3
    j = i % n
    return clip[[j + 1, j + 2, j, j + 3]][None]


def train_samples(seed: int, n: int, size: int, max_px: float, device,
                  chunk: int = 16):
    """n training samples, each its own scene: frames [n, 9, S, S, 3]
    (B0, B1, B-1, B2, St, S0, S1, S-1, S2) and t [n, 1] = k / 8, k drawn
    from 1..7, on the host in pinned memory."""
    gen = generator(seed, device, 2)
    k = torch.randint(1, STRIDE, (n,), generator=gen, device=device)
    frames = torch.empty((n, 9, size, size, 3), dtype=torch.float32,
                         pin_memory=torch.device(device).type == "cuda")
    centres = torch.tensor([0, 1, -1, 2], device=device,
                           dtype=torch.float32) * STRIDE
    for i in range(0, n, chunk):
        m = min(chunk, n - i)
        sc = make_scenes(m, size, size, max_px, gen, device)
        blur = blurry(sc, centres)                              # [m,4,...]
        s = torch.tensor([0, STRIDE, -STRIDE, 2 * STRIDE], device=device,
                         dtype=torch.float32)
        sharp = render(sc, s)                                   # S0 S1 S-1 S2
        inner = render(sc, torch.arange(1, STRIDE, device=device,
                                        dtype=torch.float32))
        st = inner[torch.arange(m, device=device), k[i:i + m] - 1]
        f = torch.cat([blur, st[:, None], sharp], 1)
        frames[i:i + m] = f.permute(0, 1, 3, 4, 2).cpu()
    return frames, (k.float() / STRIDE).reshape(n, 1).cpu()


@torch.no_grad()
def calibrate_flow_head(ref_model, sd: Dict[str, torch.Tensor],
                        frames: torch.Tensor, target: float) -> float:
    """Scale the flow channels of the backbone's output head in ``sd``
    (rows 2 nf .. 2 nf + 3 of ``ref_model.flow_head``, in place) so that
    the reference's Stage-I flows on ``frames`` [1,4,3,H,W] peak at
    ``target`` pixels; at random weights they peak near 76 px,
    motion no x8 window has. The flows are linear in those rows of the
    head's weight and bias, so nothing else changes. Returns the peak
    before scaling; no change where it is at most ``target``."""
    s1 = ref_model.extract(frames)
    peak = max(float(s1.flow_01.abs().max()), float(s1.flow_10.abs().max()))
    if peak > target and math.isfinite(peak):
        nf2 = 2 * ref_model.nf
        for k in ("weight", "bias"):
            sd[f"{ref_model.flow_head}.{k}"][nf2:nf2 + 4] *= target / peak
    return peak
