from .materials import (  # noqa: F401
    GLASS,
    LAMBERT,
    MIRROR,
    STANDARD_PBR,
    MaterialLanes,
    eval_bsdf,
    eval_pdf_bsdf,
    pdf_bsdf,
    sample_bsdf,
    is_delta,
)
