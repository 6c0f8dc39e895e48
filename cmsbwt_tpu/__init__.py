"""cmsbwt_tpu — JAX BWT of repetitive string collections via
compressed matching statistics (capabilities of fmasillo/CMS-BWT,
re-designed for JAX/XLA).

Public API:
    Config                      run configuration (reference-compatible)
    compute_bwt(cfg)            file-to-file pipeline (CLI core)
    CMSBWT                      index-once / transform-many model object
"""
from .config import Config

__version__ = "0.1.0"


def compute_bwt(cfg):
    from .engine.pipeline import compute_bwt as _impl
    return _impl(cfg)


def __getattr__(name):
    if name == "CMSBWT":
        from .models.cms_bwt import CMSBWT
        return CMSBWT
    raise AttributeError(name)
