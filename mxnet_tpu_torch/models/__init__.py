"""Model symbols of the port."""
from . import resnet  # noqa: F401
