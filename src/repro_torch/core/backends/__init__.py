"""Communicator backends — the port of ``repro.core.backends``.

- ``mediated`` : the redis / s3 store-staged communicators of the paper's
                 substrate comparison, and the hybrid (relay-fallback)
                 communicator.  The reference's SPMD ``staged_*``
                 collectives and its ``direct`` backend belong to the SPMD
                 surface, which is not ported yet (ROADMAP A 5).
"""

from repro_torch.core.backends import mediated  # noqa: F401
