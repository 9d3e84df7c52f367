"""Serverless benchmark functions (the paper's Table 1 analogs), on tensors.

SeBS/Photons-style workloads written as plain PyTorch callables, so that
they run inside the Hydra runtime as registered functions beside LM
tenants: helloworld, filehashing, thumbnail, compress, video-processing,
restapi, classify, uploader, dynamic-html. Each keeps the semantics of
the JAX catalog it mirrors, and the same names, shapes and dtypes:

* filehashing sums ``data[i] * 31**(i mod 64)`` modulo 2**32: the JAX
  catalog raises 31 to an integer array with ``jnp.power``, which takes
  the exponent's low 6 bits. torch has no uint32 ``pow`` and a uint32
  sum promotes to int64, so the products are summed in int64 (bytes x
  powers < 2**40, 4096 terms < 2**52: exact) and masked; the digest is
  a 0-d uint32.
* compress keeps the rFFT coefficients at or above the 90th percentile
  of their magnitudes (``torch.quantile``'s linear interpolation is
  ``jnp.percentile``'s default).
* restapi and classify return int32 labels, the first maximum on a tie.
* dynamic-html accumulates duplicate slots (``index_add_``); ``%`` on
  int32 is a floor mod, so a negative slot lands where the reference's
  does.

The parameters are drawn from a CPU ``torch.Generator`` seeded with
``seed`` and then moved to the device, so the card holds the same
numbers as the CPU.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.registry import CallableSpec
from repro_torch.device import resolve_device
from repro_torch.models.convert import params_from_numpy

PAGE = 2048                       # dynamic-html's page skeleton
_MASK32 = 0xFFFFFFFF


def _hello(params, args):
    return {"msg": args["x"] * 0 + 1}


@functools.lru_cache(maxsize=None)
def _powers31(n: int, device: torch.device) -> torch.Tensor:
    """``jnp.power(uint32(31), arange(n))``, 31**(i mod 64) mod 2**32, as
    int64; built once per length and device, as the JAX program folds it
    into a constant. numpy's uint32 power wraps modulo 2**32."""
    p = np.power(np.uint32(31), np.arange(n, dtype=np.uint32) % 64)
    return torch.from_numpy(p.astype(np.int64)).to(device)


def _hash(params, args):
    """Polynomial rolling hash over a byte buffer (filehashing)."""
    x = args["data"]
    powers = _powers31(x.shape[-1], x.device)
    digest = (x.to(torch.int64) * powers).sum() & _MASK32
    return {"digest": digest.to(torch.uint32)}


def _thumbnail(params, args):
    """Average-pool a 256x256x3 image to 64x64x3."""
    return {"thumb": args["image"].reshape(64, 4, 64, 4, 3).mean(dim=(1, 3))}


def _compress(params, args):
    """FFT + top-decile magnitude truncation (lossy compression)."""
    f = torch.fft.rfft(args["signal"])
    mag = f.abs()
    thresh = torch.quantile(mag, 0.9)
    return {"coeffs": torch.where(mag >= thresh, f, 0)}


def _video(params, args):
    """Temporal smoothing over a frame stack (video-processing): the
    kernel (0.25, 0.5, 0.25) along time, edge-padded."""
    frames = args["frames"]                   # (T, H, W)
    pad = torch.cat([frames[:1], frames, frames[-1:]])
    return {"out": pad[:-2] * 0.25 + pad[1:-1] * 0.5 + pad[2:] * 0.25}


def _rest(params, args):
    """Token scoring (restapi): embed + dot + softmax."""
    scores = args["query"] @ params["table"].T
    top = torch.argmax(torch.softmax(scores, dim=-1), dim=-1)
    return {"top": top.to(torch.int32)}


def _classify(params, args):
    h = torch.relu(args["features"] @ params["w1"])
    return {"label": torch.argmax(h @ params["w2"], dim=-1).to(torch.int32)}


def _uploader(params, args):
    """Checksum + chunking of a payload (uploader)."""
    x = args["payload"]
    return {"chunk_sums": x.reshape(16, -1).sum(dim=1),
            "crc": x.sum(dtype=torch.float32)}


def _html(params, args):
    """dynamic-html: template scatter of values into a page skeleton."""
    values = args["values"]
    page = torch.zeros((PAGE,), dtype=torch.float32, device=values.device)
    idx = args["slots"].to(torch.int32) % PAGE
    return {"page": page.index_add_(0, idx, values)}


# catalog key -> the params it draws: {name: (shape, scale)}, in the
# order they are drawn
_PARAMS = {
    "jv/restapi": {"table": ((128, 64), 1.0)},
    "jv/classify": {"w1": ((128, 256), 0.1), "w2": ((256, 10), 0.1)},
}


def _draw_params(seed: int) -> dict:
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return {key: {name: torch.randn(shape, generator=gen) * scale
                  for name, (shape, scale) in leaves.items()}
            for key, leaves in _PARAMS.items()}


def catalog_params_from_numpy(tree: dict, device=None) -> dict:
    """{catalog key: params} on ``device`` from the same keys' numpy
    arrays (the JAX catalog's draws, for instance), ready for
    ``catalog(params=...)``. Each leaf must have the name, shape and
    float32 dtype the catalog draws."""
    for key, leaves in tree.items():
        want = _PARAMS.get(key)
        if want is None or set(leaves) != set(want):
            raise ValueError(f"{key}: the catalog draws no params "
                             f"{sorted(leaves)}")
        for name, arr in leaves.items():
            if np.shape(arr) != want[name][0] or \
                    np.asarray(arr).dtype != np.float32:
                raise ValueError(f"{key}/{name}: {np.asarray(arr).dtype}"
                                 f"{list(np.shape(arr))}, want float32"
                                 f"{list(want[name][0])}")
    return params_from_numpy(tree, device)


def catalog(device=None, seed: int = 42, params: dict | None = None) -> dict:
    """{key: CallableSpec} of the nine functions, their example arguments
    and params on ``device`` (CUDA unless asked otherwise). ``params``
    ({key: params}, from ``catalog_params_from_numpy``) replaces the
    seeded draws of the keys it holds."""
    dev = resolve_device(device)
    drawn = _draw_params(seed)
    drawn.update(params or {})
    p = {key: {k: v.to(dev) for k, v in leaves.items()}
         for key, leaves in drawn.items()}

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "js/helloworld": CallableSpec("helloworld", _hello, {"x": zeros(8)}),
        "jv/filehashing": CallableSpec(
            "filehashing", _hash, {"data": zeros(4096, torch.uint8)}),
        "py/thumbnail": CallableSpec(
            "thumbnail", _thumbnail, {"image": zeros((256, 256, 3))}),
        "py/compress": CallableSpec(
            "compress", _compress, {"signal": zeros(8192)}),
        "py/video": CallableSpec("video", _video,
                                 {"frames": zeros((16, 64, 64))}),
        "jv/restapi": CallableSpec("restapi", _rest,
                                   {"query": zeros((4, 64))},
                                   params=p["jv/restapi"]),
        "jv/classify": CallableSpec("classify", _classify,
                                    {"features": zeros((8, 128))},
                                    params=p["jv/classify"]),
        "js/uploader": CallableSpec("uploader", _uploader,
                                    {"payload": zeros(65536)}),
        "js/dynamic-html": CallableSpec(
            "html", _html, {"slots": zeros(64, torch.int32),
                            "values": torch.ones(64, device=dev)}),
    }


def example_args(spec: CallableSpec) -> dict:
    """The spec's example arguments plus one, bytes left as they are."""
    return {k: x if x.dtype == torch.uint8 else x + 1
            for k, x in spec.example_args.items()}
