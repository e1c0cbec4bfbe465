"""The yardstick's work counts: the H100's peaks, each kernel's operations
and bytes a call (``<kernel>.py``), and the whole step's least work
(``step.py``), all counted by the benchmark, never read from the program."""
