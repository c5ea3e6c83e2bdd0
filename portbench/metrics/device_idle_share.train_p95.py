"""device_idle_share.train_p95: what device_idle_share.train reads, in the train cells whose
end-to-end metric besides setup_s is the step time's tail
(train_step_ms_p95): the host-bound steps, whose rate follows the host.
"""

from pathlib import Path

from portbench.harness import load_reader

read = load_reader(Path(__file__).resolve().parents[2], "device_idle_share.train")
