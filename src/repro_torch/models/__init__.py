"""The model stack of the port: layers, the dense decoder, the model API
and the weight carrier (``convert``)."""
