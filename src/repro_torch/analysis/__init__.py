"""What a traced step costs: the dispatch census (``census``) and the
roofline terms with the H100's constants (``roofline``)."""
