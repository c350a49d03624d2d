"""The paper's own evaluation model family: a ResNet18-style CNN whose conv
layers run through the LUT GEMM after im2col (the reference's
``configs/deepgemm_cnn.py``). Not a decoder LM: ``models/cnn.py`` builds
and runs it, ``examples/cnn_paper_repro_torch.py`` drives it."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    name: str = "deepgemm-cnn"
    # (cout, kh, kw, stride) of the stem; (cout, convs) per stage, for
    # 32x32 inputs
    stem: tuple = (64, 3, 3, 1)
    stages: tuple = ((64, 2), (128, 2), (256, 2), (512, 2))
    n_classes: int = 10
    img_hw: int = 32
    in_ch: int = 3


CONFIG = CNNConfig()
