"""Plain float32 references, one module per architecture (found by the
configuration's ``reference``), on the forward of ``plain.py``. None of
them imports the program."""
