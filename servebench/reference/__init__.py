"""The plain reference of the served models (``model.py``) and the int4
rule it works out again (``quant.py``). Plain torch in float32; imports
nothing of the program."""
