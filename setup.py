from setuptools import find_packages, setup

setup(
    name="distkeras-tpu",
    version="0.1.0",
    description=(
        "TPU-native distributed deep learning: the dist-keras trainer/"
        "transformer/predictor API on JAX/XLA meshes instead of Spark"
    ),
    long_description=open("README.md", encoding="utf-8").read(),
    long_description_content_type="text/markdown",
    license="MIT",
    packages=find_packages(include=["distkeras_tpu", "distkeras_tpu.*",
                                    "distkeras_tpu_torch", "distkeras_tpu_torch.*"]),
    # the port's CUDA kernels are compiled from source at first use
    package_data={"distkeras_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "flax",
        "optax",
        "numpy",
    ],
    extras_require={
        "keras": ["keras>=3.0"],
        "checkpoint": ["orbax-checkpoint"],
        "test": ["pytest", "chex"],
    },
    classifiers=[
        "Programming Language :: Python :: 3",
        "Topic :: Scientific/Engineering :: Artificial Intelligence",
    ],
)
