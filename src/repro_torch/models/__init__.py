"""Model zoo: the families ported so far behind the reference's family-dispatched API."""

from repro_torch.models.config import ArchConfig  # noqa: F401
from repro_torch.models import api  # noqa: F401
