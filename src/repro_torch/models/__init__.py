"""Model code of the port: layers, GQA attention, dense LM, model API."""
