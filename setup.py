"""Package metadata + native extension build.

The optional C extension (sdslam_tpu._native) provides the host-side hot
I/O paths (dataset decode/association scratch work) in C — the counterpart
of the reference's native runtime layer. The Python package works without
it. In a checkout it is built from native/*.c at first use into build/native
(sdslam_tpu/native.py; ahead of time: `python -m sdslam_tpu.native`); an
installed package gets it from this Extension.
"""

from setuptools import Extension, find_packages, setup

ext_modules = [
    Extension(
        "sdslam_tpu._native",
        sources=["native/native.c", "native/loader.c"],
        libraries=["png", "pthread"],
        extra_compile_args=["-O3", "-std=c11"],
        optional=True,
    )
]

setup(
    name="sdslam_tpu",
    version="0.1.0",
    description=(
        "Semi-direct SLAM in JAX: a JAX/XLA re-architecture of the "
        "SD-SLAM pipeline (monocular / RGB-D / mono+IMU)"
    ),
    packages=find_packages(include=["sdslam_tpu", "sdslam_tpu.*"]),
    python_requires=">=3.10",
    install_requires=["jax", "numpy", "pyyaml", "pillow", "scipy"],
    entry_points={"console_scripts": ["sdslam=sdslam_tpu.cli:main"]},
    ext_modules=ext_modules,
)
