"""Plain PyTorch references of the served networks: a frozen copy of each
network (``<network>.py``) and the forward pass that runs it (``ops.py``).
Nothing here imports the program under test."""
