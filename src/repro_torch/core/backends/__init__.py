"""Communicator backends — the port of ``repro.core.backends``.

- ``direct``   : the production path — ``torch.distributed`` collectives over
                 the named axes of a device mesh (the analogue of NAT
                 hole-punched direct TCP).
- ``mediated`` : redis / s3 store-staged backends for the paper's substrate
                 comparison (simulation pricing + an SPMD emulation that
                 moves the extra bytes of a staging hop).
"""

from repro_torch.core.backends import direct, mediated  # noqa: F401
