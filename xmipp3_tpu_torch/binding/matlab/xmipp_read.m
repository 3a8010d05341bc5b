function I = xmipp_read(filename)
%XMIPP_READ read any image/volume/stack format the framework understands
%(Spider, MRC/MRCS, .vol, TIA, DM3/4, ...). Replaces xmipp_read.cpp.
%
%   I = xmipp_read(filename)
out = xmipp_matlab_bridge('read', struct('filename', filename));
I = out.I;
end
