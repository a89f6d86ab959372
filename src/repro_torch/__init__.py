"""PyTorch/CUDA port of the quad-camera ORB visual frontend.

``repro_torch`` mirrors the JAX/Pallas package ``repro`` module for
module (``core/``, ``kernels/``, ``localization/``, ``data/``) and runs
the session's frame path (``VisualSystem.process_frame``), its localized
form and ``run``, the matcher entry points, the single-image FE API
(``core.fast``, ``core.brief``, ``core.pyramid.build_pyramid``,
``core.extract_features``), the unfused Feature Matcher schedule
(``core.match_pair_unfused``) and the legacy free-function shims
(``core.frontend``), with PyTorch around ten kernels written by hand in
CUDA C++ for Hopper (``kernels/csrc/``).  It imports
neither jax nor any module of ``repro``; the comparison tests under
``tests/port/`` are the only code that imports both.

Every kernel wrapper decides by the device of the tensor it is given:
on a CPU tensor it runs the kernel's plain PyTorch version, on a CUDA
tensor it launches the hand-written kernel (built at first use) or
raises.  Entry points default to ``device="cuda"``.
"""
