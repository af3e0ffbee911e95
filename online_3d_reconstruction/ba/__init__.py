from online_3d_reconstruction.ba.problem import BAProblem  # noqa: F401
from online_3d_reconstruction.ba.schur import solve_ba  # noqa: F401
from online_3d_reconstruction.ba.window import WindowBA  # noqa: F401
