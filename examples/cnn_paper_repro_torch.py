"""The paper's own setting on the port: a CNN whose conv layers run as LUT
GEMMs (the counterpart of examples/cnn_paper_repro.py).

Builds the ResNet18-style deepgemm-cnn (the stem and 8 stage convs, all
3x3 at stride 1, ReLU, a global mean) from seed-drawn weights, packs every
conv's filter matrix to 2 bits, and runs the w2a2 LUT path (im2col ->
per-row activation quantization and packing -> ``lut_gemm`` -> scales)
against the fp32 forward: packed bytes, both times and the feature cosine.

  PYTHONPATH=src python examples/cnn_paper_repro_torch.py            # card
  PYTHONPATH=src python examples/cnn_paper_repro_torch.py --smoke --device cpu
"""

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.qlinear import QuantPolicy
from repro_torch.models import cnn

BATCH, SEED = 4, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--smoke", action="store_true",
                    help="widths 8-16 and 8x8 images, for the CPU")
    args = ap.parse_args(argv)
    cfg = get_config("deepgemm-cnn")
    if args.smoke:
        cfg = cnn.reduce_for_smoke(cfg)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = cnn.init_params(cfg, gen, dev)
    x = torch.randn((BATCH, cfg.img_hw, cfg.img_hw, cfg.in_ch), generator=gen, device=dev)
    qws = cnn.quantize(params, QuantPolicy(w_bits=2, a_bits=2))
    packed = sum(q.packed.numel() for q in qws)
    f32 = sum(p["w"].numel() * 4 for p in params)
    print(f"conv weights: {f32 / 1e6:.2f} MB f32 -> {packed / 1e6:.2f} MB packed "
          f"2-bit ({f32 / packed:.1f}x)")

    def timed(fn):
        fn()                                   # warm-up (and the kernels' build)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return y, time.perf_counter() - t0

    with torch.inference_mode():
        y_fp, t_fp = timed(lambda: cnn.forward_plain(params, x))
        y_q, t_q = timed(lambda: cnn.forward_lut(qws, x, a_bits=2))
    cos = float((y_fp * y_q).sum() / (y_fp.norm() * y_q.norm() + 1e-9))
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"fp32 fwd {t_fp * 1e3:.1f} ms | w2a2 LUT fwd {t_q * 1e3:.1f} ms "
          f"| feature cosine {cos:.3f} ({where}, batch {BATCH})")
    if cos <= 0.3:
        raise SystemExit("2-bit features should correlate with fp32")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
