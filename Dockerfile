# gramtools-tpu container: CPU-correct everywhere, fast on NVIDIA GPUs.
#
# Mirrors the reference's container story (its ci/docker/)
# with a single image: the package's native helpers (SA-IS suffix sort,
# fastx parser, OpenMP baseline) compile on first use with g++, and JAX
# uses the GPU when the container runs with one (docker run --gpus all).
FROM python:3.12-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ zlib1g-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/gramtools-tpu
COPY pyproject.toml README.md ./
COPY gramtools_tpu ./gramtools_tpu

# JAX with its CUDA 12 plugin by default; for a CPU-only image build
# with --build-arg JAX_SPEC="jax[cpu]"
ARG JAX_SPEC="jax[cuda12]"
RUN pip install --no-cache-dir ${JAX_SPEC} numpy && pip install --no-cache-dir .

# pre-build the native library so first run needs no compiler warm-up;
# portable ISA (no -march=native) so the image runs on older CPUs than
# the build host
ENV GRAMTOOLS_TPU_MARCH=portable
# an installed package sets no compile-cache directory of its own
ENV JAX_COMPILATION_CACHE_DIR=/var/cache/gramtools-tpu-xla
RUN python -c "from gramtools_tpu.index.native import get_native_lib; \
assert get_native_lib() is not None"

ENTRYPOINT ["gramtools-tpu"]
