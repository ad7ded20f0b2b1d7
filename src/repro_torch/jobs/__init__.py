"""`repro_torch.jobs` — futures-based serverless job layer over the priced substrate.

The Lithops FunctionExecutor idiom on the repo's simulation machinery:

>>> ex = JobExecutor(provider="aws-lambda")
>>> fs = ex.map(lambda x: x * x, range(8))
>>> done, _ = wait(fs, return_when=ANY_COMPLETED)
>>> get_result(fs)                      # [0, 1, 4, ...]
>>> fs[0].job.cost_usd                  # every invocation billed

See :mod:`repro_torch.jobs.executor` for the execution/billing model,
:mod:`repro_torch.jobs.partitioner` for object-store dataset splitting, and
:mod:`repro_torch.dataframe.io` for the out-of-core CSV ETL built on both.
"""

from repro_torch.jobs.futures import (  # noqa: F401
    ALL_COMPLETED,
    ANY_COMPLETED,
    Future,
    get_result,
    wait,
)
from repro_torch.jobs.executor import (  # noqa: F401
    JobExecutor,
    JobReport,
    RetryPolicy,
    SpeculationPolicy,
    TaskAttempt,
    TaskError,
    TaskRecord,
)
from repro_torch.jobs.partitioner import (  # noqa: F401
    DataPartition,
    partition_dataset,
)
