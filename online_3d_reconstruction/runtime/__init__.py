from online_3d_reconstruction.runtime.pipeline import (  # noqa: F401
    OnlineReconstructor,
    ReconstructionResult,
    reconstruct,
)
