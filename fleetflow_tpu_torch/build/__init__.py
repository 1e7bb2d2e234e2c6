"""Image build/push subsystem (L1b; the port's copy of
``fleetflow_tpu/build``).

Analog of fleetflow-build (SURVEY.md §2.1b): resolve build inputs from a
service's `build{}` config (dockerfile / context / args / tag), pack the
context into a tar.gz honoring .dockerignore, authenticate against
registries from ~/.docker/config.json, and drive `docker build` / `docker
push` (the reference streams through Bollard's build API; the CLI carries
the same operations).
"""

from .resolver import BuildResolver, ResolvedBuild
from .context import create_context, load_dockerignore
from .auth import RegistryAuth, registry_for_image
from .builder import ImageBuilder, ImagePusher

__all__ = ["BuildResolver", "ResolvedBuild", "create_context",
           "load_dockerignore", "RegistryAuth", "registry_for_image",
           "ImageBuilder", "ImagePusher"]
