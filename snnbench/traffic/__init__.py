"""Traffic: ``<name>.json`` files of parameters, each naming its arrival
process, ``<generator>.py`` (``snnbench/schedule.py`` reads both)."""
