function img_out = tom_xmipp_mirror(img, flipstring)
%TOM_XMIPP_MIRROR mirror around the axes named in FLIPSTRING ('x','y',
%'xy','xyz', ...). Replaces tom_xmipp_mirror.cpp.
%
%   img_out = tom_xmipp_mirror(img, flipstring)
out = xmipp_matlab_bridge('mirror', struct('img', img, ...
    'flipstring', flipstring));
img_out = out.img_out;
end
