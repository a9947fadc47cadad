"""Plain PyTorch references of the served networks: a frozen copy of each
network (``<network>.py``), the forward pass that runs it (``ops.py``) and
a file for each layer kind that ``ops.py`` does not build in
(``kinds/<kind>.py``).  Nothing here imports the program under test."""
