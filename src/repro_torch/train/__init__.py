"""Training and serving steps (``steps.py``), AdamW (``optimizer.py``) and
int8 gradient compression (``compress.py``)."""
