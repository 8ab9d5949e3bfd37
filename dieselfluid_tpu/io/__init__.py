"""Persistence: checkpoint/resume, animation export, JSON sample sets.

The reference has NO simulation checkpointing (SURVEY.md §5) and lists
"Fluid Animation Export" as an unmet requirement (ref: README.MD:39); this
package closes both gaps, plus parity for the sampler JSON format
(ref: sampler/sampler_json.go). `io.checkpoint` needs orbax and is imported
only by the code paths that checkpoint.
"""

from dieselfluid_tpu.io.animation import AnimationWriter  # noqa: F401
from dieselfluid_tpu.io.sampler_json import SamplerJSON  # noqa: F401
