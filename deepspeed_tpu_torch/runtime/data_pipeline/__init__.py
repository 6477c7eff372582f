"""The data-efficiency pipeline's curriculum: difficulty schedules
(:mod:`.curriculum_scheduler`) and curriculum sampling and seqlen
truncation (:mod:`.data_sampler`).  Random-LTD is not ported yet
(``ROADMAP.md`` Queue 1 item 10)."""

from .curriculum_scheduler import CurriculumScheduler
from .data_sampler import (CurriculumDataLoader, CurriculumSampler,
                           DeepSpeedDataSampler, truncate_batch)

__all__ = ["CurriculumDataLoader", "CurriculumSampler", "CurriculumScheduler",
           "DeepSpeedDataSampler", "truncate_batch"]
