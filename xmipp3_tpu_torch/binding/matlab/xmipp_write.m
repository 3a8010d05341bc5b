function xmipp_write(array, filename)
%XMIPP_WRITE write an image/volume/stack in any supported format.
%Replaces xmipp_write.cpp.
%
%   xmipp_write(array, filename)
xmipp_matlab_bridge('write', struct('array', array, 'filename', filename));
end
