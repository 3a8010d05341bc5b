function s = xmipp_read_metadata(fnmetadata)
%XMIPP_READ_METADATA read a .xmd/.doc/.star metadata file into a struct of
%column arrays (numeric columns as vectors, string columns as cell
%arrays). Replaces the reference's pure-MATLAB parser.
s = xmipp_matlab_bridge('read_metadata', struct('filename', fnmetadata));
end
