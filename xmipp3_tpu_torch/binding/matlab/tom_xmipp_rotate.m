function img_out = tom_xmipp_rotate(img, angs, axis, align_z, gridding, wrap)
%TOM_XMIPP_ROTATE rotate a 2D image (angs = psi degrees) or 3D volume
%(angs = [rot tilt psi] Euler degrees, or a scalar angle about AXIS, or a
%rotation aligning ALIGN_Z to the z axis). Replaces tom_xmipp_rotate.cpp.
%
%   img_out = tom_xmipp_rotate(img, angs, axis, align_z, gridding, wrap)
if nargin < 6, wrap = true; end
if nargin < 5, gridding = false; end
if nargin < 4, align_z = []; end
if nargin < 3, axis = []; end
out = xmipp_matlab_bridge('rotate', struct('img', img, 'angs', angs, ...
    'axis', axis, 'align_z', align_z, 'gridding', gridding, 'wrap', wrap));
img_out = out.img_out;
end
