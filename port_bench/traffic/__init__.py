"""Traffic: each mix is a data file ``<mix>.json`` whose ``kind`` names its
generator and loop, ``<kind>.py``."""
